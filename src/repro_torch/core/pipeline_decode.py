"""Autoregressive decoding THROUGH the DEFER pipeline (the twin of
``repro.core.pipeline_decode``; beyond-paper).

The paper pipelines independent inference samples; autoregressive LMs add
a twist the paper never faced: token t+1 cannot enter the chain until
token t leaves it.  Keep M >= S *microbatches* (groups of sequences) in
flight — while microbatch m's token is at stage s, microbatch m+1's is at
stage s-1 — and hand the generated token from the LAST stage straight back
to stage 0, so the dispatcher round-trip disappears.

Schedule (the reference's, tick by tick): ``M * steps + S - 1`` ticks; at
tick t stage s serves microbatch m = (t-s) mod M at decode step
p = (t-s) div M, valid while 0 <= t-s < M*steps.  Stage 0 embeds the
prompt token in the first round and, after it, the token its
per-microbatch buffer banked: the one the last stage produced for that
microbatch at an earlier tick.  With M < S that token has not come back
yet when stage 0 needs it, and stage 0 reads what the buffer holds (a
token of an earlier step, or 0), as the reference does.

As in :mod:`repro_torch.core.pipeline`, a stage skips the ticks where it
has nothing valid to serve, so a cache is committed only on a valid tick
and written in place (the microbatch's slice of its stage's caches); the
head runs on the last stage only; and only relays that a stage reads are
made: the hidden state from stage s to s+1, the token from the last stage
to stage 0.  With ``compress=True`` a call quantizes ``M * steps * (S-1)``
hidden states (one launch of each block-quant kernel per relay on a card
with ``quant_impl="kernel"``); the token rides raw.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch.core.graph import tree_leaves, tree_map
from repro_torch.core.pipeline import (PipelineConfig, RelayLog, _devices,
                                       relay, stage_slice)


def _commit(dst: Any, src: Any) -> None:
    """Copy each new cache leaf into its slot, where it is not the slot's
    own tensor already (an attention layer writes its slot in place)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if s is not d:
            d.copy_(s)


def pipeline_decode_apply(stage_params: Any, caches: Any,
                          start_tok: torch.Tensor, start_pos: torch.Tensor,
                          head: Any, *, decode_unit_fn: Callable,
                          embed_fn: Callable, head_fn: Callable, steps: int,
                          cfg: PipelineConfig,
                          devices: Sequence[torch.device] | None = None,
                          log: RelayLog | None = None):
    """Run the decode chain (every stage, every tick) in this process.

    stage_params: (units [S, u, ...], valid [S, u]).
    caches: unit caches, leaves [S, u, M, ...]; written in place.
    start_tok [M, mb, 1] int32; start_pos [M, mb] int32.
    head: embed/final-norm/unembed params (and zamba2's shared block).
    ``decode_unit_fn(local_w, h, pos, mcache, head) -> (h, new mcache)``.
    Returns (tokens [M, steps, mb], caches).
    """
    S, M = cfg.num_stages, cfg.num_microbatches
    mb = start_tok.shape[1]
    devs = _devices(devices, start_tok, S)
    log = RelayLog() if log is None else log
    local_w = [stage_slice(stage_params, s, devs[s]) for s in range(S)]
    local_c = [stage_slice(caches, s, devs[s]) for s in range(S)]
    heads = [tree_map(lambda a, d=d: a.to(d, non_blocking=True), head)
             for d in devs]
    prompt = start_tok.to(devs[0], non_blocking=True)
    pos0 = [start_pos.to(d, non_blocking=True) for d in devs]
    tok_buf = torch.zeros((M, mb, 1), dtype=torch.int32, device=devs[0])
    out = torch.zeros((M, steps, mb), dtype=torch.int32, device=devs[-1])
    inbox: list = [None] * S
    for t in range(M * steps + S - 1):
        nxt: list = [None] * S
        # stage 0 first: it reads its token before the last stage banks one
        for s in range(max(0, t - M * steps + 1), min(S, t + 1)):
            k = t - s
            m, p = k % M, k // M
            if s == 0:
                tok_in = prompt[m] if k < M else tok_buf[m]
                h_in = embed_fn(heads[0], tok_in)
            else:
                h_in = inbox[s]
            mcache = tree_map(lambda a: a[:, m], local_c[s])   # [u, ...]
            h_out, new_mcache = decode_unit_fn(local_w[s], h_in,
                                               pos0[s][m] + p, mcache,
                                               heads[s])
            _commit(mcache, new_mcache)
            if s == S - 1:
                logits = head_fn(heads[s], h_out)              # [mb, 1, V]
                new_tok = logits.argmax(dim=-1).to(torch.int32)  # [mb, 1]
                out[m, p] = new_tok[:, 0]
                tok_buf[m] = relay(new_tok, devs[0], cfg, log)
            else:
                nxt[s + 1] = relay(h_out, devs[s + 1], cfg, log)
        inbox = nxt
    # a stage on another device than the stack worked on a copy
    for s in range(S):
        for whole, part in zip(tree_leaves(caches), tree_leaves(local_c[s])):
            if part.data_ptr() != whole[s].data_ptr():
                whole[s].copy_(part)
    return out, caches


class PipelineDecoder:
    """``fn(stage_params, caches, start_tok, start_pos, head) -> (tokens
    [M, steps, mb], caches)`` (see :func:`pipeline_decode_apply`);
    ``relayed`` is its last call's :class:`RelayLog`."""

    def __init__(self, mesh, cfg: PipelineConfig, steps: int, **fns):
        self.mesh, self.cfg, self.steps, self.fns = mesh, cfg, steps, fns
        self.relayed = RelayLog()

    def __call__(self, stage_params, caches, start_tok, start_pos, head):
        self.relayed = RelayLog()
        return pipeline_decode_apply(
            stage_params, caches, start_tok, start_pos, head,
            steps=self.steps, cfg=self.cfg, devices=self.mesh.devices,
            log=self.relayed, **self.fns)


def make_pipeline_decoder(mesh, cfg: PipelineConfig, *, decode_unit_fn,
                          embed_fn, head_fn, steps: int) -> PipelineDecoder:
    """Decode-pipeline callable over ``mesh`` (one device per stage).

    fn(stage_params, caches, start_tok, start_pos, head)
      -> (tokens [M, steps, mb], caches)

    stage_params leaves [S, u, ...]; caches leaves [S, u, M, ...], updated
    in place (the reference returns new ones).
    """
    if mesh.num_stages != cfg.num_stages:
        raise ValueError(f"mesh has {mesh.num_stages} stages, the config "
                         f"{cfg.num_stages}")
    return PipelineDecoder(mesh, cfg, steps, decode_unit_fn=decode_unit_fn,
                           embed_fn=embed_fn, head_fn=head_fn)
