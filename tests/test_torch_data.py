"""The port's synthetic data pipeline (``data/pipeline.py``) against the
JAX package's: the same seeds and steps give byte-equal arrays from
``TokenStream`` (shards, prefix and encoder embeds), ``ImageStream`` and
``make_lm_iter`` for every smoke config; ``Prefetcher`` keeps order; the
reference test's structure checks hold on the port's stream."""
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as J
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as T

torch.set_num_threads(1)

STEPS = 4


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kw", [
    dict(vocab=100, batch=8, seq_len=16, seed=3),
    dict(vocab=49152, batch=4, seq_len=33, seed=0, shard=1, num_shards=2),
    dict(vocab=512, batch=6, seq_len=8, seed=7, shard=2, num_shards=3,
         prefix_embeds=(8, 64)),
    dict(vocab=512, batch=2, seq_len=8, seed=1, encoder_embeds=(8, 32)),
], ids=["plain", "shard", "prefix", "encoder"])
def test_token_stream_is_byte_equal_to_the_reference(kw):
    a, b = J.TokenStream(**kw), T.TokenStream(**kw)
    for _ in range(STEPS):
        _same(next(a), next(b))


@pytest.mark.parametrize("kw", [dict(batch=2, image=32, seed=0),
                                dict(batch=1, image=64, channels=1, seed=5)])
def test_image_stream_is_byte_equal_to_the_reference(kw):
    a, b = J.ImageStream(**kw), T.ImageStream(**kw)
    for _ in range(STEPS):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype == np.float32
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_make_lm_iter_matches_the_reference(arch):
    ja = J.make_lm_iter(jreg.get_smoke(arch), 4, 16, seed=2)
    tb = T.make_lm_iter(treg.get_smoke(arch), 4, 16, seed=2)
    assert isinstance(tb, T.Prefetcher)
    for _ in range(STEPS):
        _same(next(ja), next(tb))
    raw = T.make_lm_iter(treg.get_smoke(arch), 4, 16, seed=2, prefetch=0)
    assert isinstance(raw, T.TokenStream)


def test_prefetcher_preserves_order():
    assert list(T.Prefetcher(iter(range(20)), depth=4)) == list(range(20))


def test_stream_is_deterministic_sharded_and_shifted():
    a = next(T.TokenStream(100, 8, 16, seed=3))
    b = next(T.TokenStream(100, 8, 16, seed=3))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    s0 = next(T.TokenStream(100, 8, 16, seed=3, shard=0, num_shards=2))
    s1 = next(T.TokenStream(100, 8, 16, seed=3, shard=1, num_shards=2))
    assert s0["tokens"].shape == (4, 16)
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    whole = next(T.TokenStream(100, 8, 17, seed=3))
    np.testing.assert_array_equal(whole["tokens"][:, 1:],
                                  whole["labels"][:, :-1])


def test_stream_has_learnable_structure():
    it = T.TokenStream(50, 16, 64, seed=0)
    hits = tot = 0
    for _ in range(5):
        b = next(it)
        delta = (b["labels"] - b["tokens"]) % 50
        _, counts = np.unique(delta, return_counts=True)
        hits += counts.max()
        tot += delta.size
    assert hits / tot > 0.10
