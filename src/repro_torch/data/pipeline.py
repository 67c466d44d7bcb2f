"""Deterministic synthetic data pipeline (token LM + image batches); the
twin of ``repro.data.pipeline``, a copy of its numpy code (the port may not
import the reference), so the same seed gives the same bytes in both.
Batches are numpy arrays; the train loop moves them to the device.

Seeded, shard-aware, infinite; a background thread keeps a small prefetch
queue full so the train loop never blocks on generation.  The token stream
is a structured Markov-ish source (not uniform noise) so cross-entropy has
learnable signal — the end-to-end example's loss must visibly drop.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class TokenStream:
    """Synthetic LM batches {tokens [B,S], labels [B,S]}.

    A per-sequence hidden phase drives a noisy arithmetic progression over
    the vocab, giving next-token structure a model can learn.  ``shard``/
    ``num_shards`` slice the global batch for multi-host feeding.
    """

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1,
                 prefix_embeds: tuple[int, int] | None = None,
                 encoder_embeds: tuple[int, int] | None = None):
        assert batch % num_shards == 0
        self.vocab = vocab
        self.local_batch = batch // num_shards
        self.seq_len = seq_len
        self.seed = seed
        self.shard = shard
        self.prefix_embeds = prefix_embeds       # (n, d) stub frontend output
        self.encoder_embeds = encoder_embeds
        self._step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self._step) * 97 + self.shard)
        self._step += 1
        B, S, V = self.local_batch, self.seq_len, self.vocab
        start = rng.integers(0, V, (B, 1))
        stride = rng.integers(1, 7, (B, 1))
        base = (start + stride * np.arange(S + 1)[None]) % V
        noise = rng.integers(0, V, (B, S + 1))
        mask = rng.random((B, S + 1)) < 0.1
        toks = np.where(mask, noise, base).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.prefix_embeds:
            n, d = self.prefix_embeds
            out["prefix_embeds"] = rng.normal(size=(B, n, d)).astype(np.float32) * 0.02
        if self.encoder_embeds:
            n, d = self.encoder_embeds
            out["encoder_embeds"] = rng.normal(size=(B, n, d)).astype(np.float32) * 0.02
        return out


class ImageStream:
    """Synthetic NHWC image batches (for the CNN / edge-emulation path)."""

    def __init__(self, batch: int, image: int = 224, channels: int = 3,
                 seed: int = 0):
        self.batch, self.image, self.channels = batch, image, channels
        self.seed = seed
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 7919 + self._step)
        self._step += 1
        # smooth, activation-like images (compressible, like real photos)
        x = rng.normal(size=(self.batch, self.image, self.image, self.channels))
        x = x.cumsum(axis=1).cumsum(axis=2)
        x /= np.abs(x).max() + 1e-9
        return x.astype(np.float32)


class Prefetcher:
    """Background-thread prefetch wrapper around any iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_lm_iter(cfg, batch: int, seq_len: int, seed: int = 0,
                 shard: int = 0, num_shards: int = 1, prefetch: int = 2):
    """Token iterator matched to a ModelConfig (adds stub frontend embeds)."""
    prefix = (cfg.num_prefix_embeds, cfg.d_model) \
        if cfg.num_prefix_embeds and not cfg.encoder_layers else None
    enc = (cfg.num_prefix_embeds, cfg.d_model) if cfg.encoder_layers else None
    stream = TokenStream(cfg.vocab, batch, seq_len, seed, shard, num_shards,
                         prefix_embeds=prefix, encoder_embeds=enc)
    return Prefetcher(stream, prefetch) if prefetch else stream
