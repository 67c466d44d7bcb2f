"""Slice C's compute in the port against the JAX reference, module by
module: the primitive layers, attention (chunked, banded, cached decode on
float and int8 caches) and decode attention (the plain version, and the
wrappers that launch the CUDA kernel on a card).

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the decode-attention wrapper runs its plain version; the CUDA
kernel is held against it in the ``cuda`` tests, which skip without a
card (``chip_smoke.py`` runs the same checks there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

# f32 elementwise layers: both sides round alike up to a few ulps
LAYER_ATOL = 1e-6
# attention: matmuls and softmax sums in another order than XLA's
ATTN_ATOL = 1e-5
# bf16 inputs: the reference sweep's own bar (tests/test_kernels.py)
BF16_ATOL = 2e-2


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree -> (jnp tree, torch tree) holding the same values."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), tree))


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


# -- layers ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 32), (1, 1, 64)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape, 3.0)
    p = {"scale": rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)}
    pj, pt = _both(p)
    _close(tlayers.rmsnorm(pt, torch.from_numpy(x)),
           jlayers.rmsnorm(pj, jnp.asarray(x)), LAYER_ATOL)


@pytest.mark.parametrize("hd", [8, 64, 128])
def test_apply_rope_matches_jax_up_to_position_4096(hd):
    rng = np.random.default_rng(hd)
    S, H = 64, 2
    x = _rand(rng, (2, S, H, hd))
    pos = np.stack([np.arange(S), np.linspace(0, 4096, S).astype(np.int64)]
                   ).astype(np.int32)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10_000.0)
    _close(got, jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                   10_000.0), LAYER_ATOL)
    # the halves rotate as pairs: position 0 is the identity
    assert torch.equal(got[0, 0], torch.from_numpy(x[0, 0]))


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_matches_jax(gated):
    rng = np.random.default_rng(3)
    d, f = 32, 64
    p = tlayers.init_mlp(rng, d, f, gated, np.float32)
    p["ln"]["scale"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
    # fan-in weights N(0, 1/fan_in) (He init halved) and activations of
    # scale 0.5 keep the output near unit scale, so LAYER_ATOL is a few
    # ulps of it (the two packages sum the d_ff products in other orders)
    for k in ("up", "down", "gate"):
        if k in p:
            p[k]["w"] = p[k]["w"] * np.float32(np.sqrt(0.5))
    x = _rand(rng, (2, 3, d), 0.5)
    pj, pt = _both(p)
    got = tlayers.mlp(pt, torch.from_numpy(x))
    _close(got, jlayers.mlp(pj, jnp.asarray(x)), LAYER_ATOL)
    assert tlayers.mlp_flops(d, f, gated, 5) == \
        jlayers.mlp_flops(d, f, gated, 5)


def test_embed_unembed_and_linear_match_jax():
    rng = np.random.default_rng(4)
    p = tlayers.init_embedding(rng, 50, 16, np.float32)
    tok = rng.integers(0, 50, (2, 7)).astype(np.int32)
    pj, pt = _both(p)
    e = tlayers.embed(pt, torch.from_numpy(tok))
    assert e.numpy().tobytes() == np.asarray(
        jlayers.embed(pj, jnp.asarray(tok))).tobytes()
    _close(tlayers.unembed(pt, e), jlayers.unembed(pj, jnp.asarray(e.numpy())),
           LAYER_ATOL)


# -- attention -----------------------------------------------------------------------

SPEC = dict(d_model=32, num_heads=4, kv_heads=2, head_dim=8)


def _attn_params(seed, spec):
    rng = np.random.default_rng(seed)
    p = tattn.init_attn(rng, spec, np.float32)
    p["ln"]["scale"] = rng.uniform(0.5, 1.5, spec.d_model).astype(np.float32)
    return p


@pytest.mark.parametrize("q_chunk,window", [(1024, None), (4, None), (4, 6),
                                            (8, 5), (5, None), (5, 6)])
def test_attention_matches_jax(q_chunk, window):
    """One chunk, several chunks (q_chunk 4 over S=16), the banded
    sliding-window path, and chunks of 5 over S=16, the last of one row
    (the reference attends such an S in one chunk)."""
    kw = dict(SPEC, q_chunk=q_chunk, window=window)
    ts, js = tattn.AttnSpec(**kw), jattn.AttnSpec(**kw)
    p = _attn_params(1, ts)
    rng = np.random.default_rng(2)
    B, S = 2, 16
    x = _rand(rng, (B, S, 32))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    pj, pt = _both(p)
    got = tattn.attention(pt, ts, torch.from_numpy(x), torch.from_numpy(pos))
    want = jattn.attention(pj, js, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want, ATTN_ATOL)


def test_cross_attention_matches_jax():
    ts, js = tattn.AttnSpec(**SPEC), jattn.AttnSpec(**SPEC)
    p = _attn_params(5, ts)
    rng = np.random.default_rng(6)
    x, enc = _rand(rng, (2, 3, 32)), _rand(rng, (2, 7, 32))
    mask = rng.random((2, 7)) > 0.3
    pj, pt = _both(p)
    got = tattn.cross_attention(pt, ts, torch.from_numpy(x),
                                torch.from_numpy(enc), torch.from_numpy(mask))
    want = jattn.cross_attention(pj, js, jnp.asarray(x), jnp.asarray(enc),
                                 jnp.asarray(mask))
    _close(got, want, ATTN_ATOL)


def _decode_inputs(seed, quant, C=24, B=3):
    rng = np.random.default_rng(seed)
    spec = tattn.AttnSpec(**SPEC)
    p = _attn_params(seed, spec)
    x = _rand(rng, (B, 1, 32))
    pos = np.array([5, 11, 23][:B], np.int32)
    kpos = np.full((B, C), -1, np.int32)
    for b in range(B):
        kpos[b, :pos[b]] = np.arange(pos[b])
    if quant:
        cache = {"k": rng.integers(-127, 128, (B, C, 2, 8)).astype(np.int8),
                 "v": rng.integers(-127, 128, (B, C, 2, 8)).astype(np.int8),
                 "kscale": rng.uniform(0.001, 0.02, (B, C, 2)).astype(np.float32),
                 "vscale": rng.uniform(0.001, 0.02, (B, C, 2)).astype(np.float32)}
    else:
        cache = {"k": _rand(rng, (B, C, 2, 8)), "v": _rand(rng, (B, C, 2, 8))}
    return p, x, pos, cache, kpos


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_attention_decode_matches_jitted_jax_step(quant, use_kernel):
    """One decode step on a float cache and on an int8 cache.  The int8
    bytes written are identical to the JITTED reference step's (compiled
    XLA scales by absmax·f32(1/127)); the outputs agree to ATTN_ATOL."""
    p, x, pos, cache, kpos = _decode_inputs(7, quant)
    js = jattn.AttnSpec(**SPEC)
    pj, _ = _both(p)
    step = jax.jit(functools.partial(jattn.attention_decode, s=js))
    out_j, cache_j, kpos_j = step(pj, x=jnp.asarray(x), pos=jnp.asarray(pos),
                                  cache=jax.tree_util.tree_map(jnp.asarray,
                                                               cache),
                                  kpos=jnp.asarray(kpos))
    _, pt = _both(p)
    cache_t = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    out_t, cache_t, kpos_t = tattn.attention_decode(
        pt, tattn.AttnSpec(**SPEC), torch.from_numpy(x),
        torch.from_numpy(pos), cache_t, torch.from_numpy(kpos.copy()),
        use_kernel=use_kernel)
    _close(out_t, out_j, ATTN_ATOL)
    assert kpos_t.numpy().tobytes() == np.asarray(kpos_j).tobytes()
    for k in cache:
        if cache[k].dtype == np.int8:
            assert cache_t[k].numpy().tobytes() == \
                np.asarray(cache_j[k]).tobytes(), k
        elif k.endswith("scale"):
            # the new row's K/V projections differ in the last bits (other
            # summation order), and its absmax scale with them, by a few
            # ulps; quant_rows itself is byte-identical on equal inputs
            np.testing.assert_allclose(cache_t[k].numpy(),
                                       np.asarray(cache_j[k]), rtol=1e-6,
                                       atol=0)
        else:
            _close(cache_t[k], cache_j[k], ATTN_ATOL)


def test_quant_rows_byte_identical_to_jitted_jax():
    rng = np.random.default_rng(8)
    x = _rand(rng, (64, 2, 128), 3.0)
    x[0, 0] = 0.0                                    # all-zero row: scale 1
    qj, sj = jax.jit(jattn.quant_rows)(jnp.asarray(x))
    qt, st = tattn.quant_rows(torch.from_numpy(x))
    assert qt.numpy().tobytes() == np.asarray(qj).tobytes()
    assert st.numpy().tobytes() == np.asarray(sj).tobytes()
    assert st[0, 0] == 1.0
    dj = jattn.dequant_rows(qj, sj)
    assert tattn.dequant_rows(qt, st).numpy().tobytes() == \
        np.asarray(dj).tobytes()


def test_init_cache_and_attn_flops_match_jax():
    for window in (None, 16):
        kw = dict(SPEC, window=window)
        ts, js = tattn.AttnSpec(**kw), jattn.AttnSpec(**kw)
        for quant in (False, True):
            ct = tattn.init_cache(ts, 2, 40, torch.float32, quant, device="cpu")
            cj = jattn.init_cache(js, 2, 40, jnp.float32, quant)
            assert {k: tuple(v.shape) for k, v in ct.items()} == \
                {k: v.shape for k, v in cj.items()}
        assert tattn.attn_flops(ts, 7, 100) == jattn.attn_flops(js, 7, 100)


# -- decode attention: the plain version and the wrappers ------------------------

# tests/test_kernels.py's sweep, then the zoo's widest heads: gemma3-4b's
# (G 2 at hd 256), granite-34b's (MQA, G 48) and G 5 at hd 96; then hd 100,
# the shared-memory form's domain
SWEEP = [(1, 4, 4, 64, 256), (2, 8, 2, 64, 512), (2, 8, 1, 128, 1024),
         (1, 16, 4, 80, 640), (2, 8, 4, 256, 1024), (1, 48, 1, 128, 512),
         (2, 40, 8, 96, 640), (2, 8, 2, 100, 256)]


def _da_inputs(B, H, kv, hd, C, seed=0, empty=50):
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, s) for s in ((B, 1, H, hd), (B, C, kv, hd),
                                       (B, C, kv, hd)))
    kpos = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    kpos[kpos > C - empty] = -1                     # empty ring slots
    pos = np.full((B,), C - empty, np.int32)
    return q, k, v, kpos, pos


def _as(dtype, *arrs):
    if dtype == "bf16":
        return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
                [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,H,kv,hd,C", SWEEP)
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_jax_ref_and_pallas(B, H, kv, hd, C, window,
                                                     dtype):
    """The port's plain version against the JAX oracle, and the port's
    wrapper (plain on the CPU) against the Pallas kernel in interpret
    mode."""
    q, k, v, kpos, pos = _da_inputs(B, H, kv, hd, C, seed=C + hd)
    (qj, kj, vj), (qt, kt, vt) = _as(dtype, q, k, v)
    scale = 1.0 / np.sqrt(hd)
    tol = BF16_ATOL if dtype == "bf16" else ATTN_ATOL
    want_ref = jref.decode_attention_ref(qj, kj, vj, jnp.asarray(kpos),
                                         jnp.asarray(pos), window, scale)
    got_ref = tref.decode_attention_ref(qt, kt, vt, torch.from_numpy(kpos),
                                        torch.from_numpy(pos), window, scale)
    assert got_ref.dtype == torch.float32
    _close(got_ref, want_ref, tol)
    want_ops = jops.decode_attention(qj, kj, vj, jnp.asarray(kpos),
                                     jnp.asarray(pos), window, scale)
    got_ops = tops.decode_attention(qt, kt, vt, torch.from_numpy(kpos),
                                    torch.from_numpy(pos), window, scale)
    assert got_ops.dtype == qt.dtype and got_ops.shape == qt.shape
    _close(got_ops, want_ops, tol)


@pytest.mark.parametrize("C", [650, 100])
def test_decode_attention_pad_path_matches_pallas(C):
    """C not a multiple of either package's block: both wrappers pad the
    cache with kpos = -1, which masks the padding out."""
    q, k, v, kpos, pos = _da_inputs(2, 8, 2, 64, C, seed=C, empty=10)
    tda.reset_counts()
    got = tops.decode_attention(*[torch.from_numpy(a) for a in
                                  (q, k, v, kpos, pos)], 32, 0.125)
    want = jops.decode_attention(*[jnp.asarray(a) for a in
                                   (q, k, v, kpos, pos)], 32, 0.125)
    _close(got, want, ATTN_ATOL)
    assert tda.plain_calls == {"decode_attention": 1}
    assert tda.launches == {"decode_attention": 0}


def test_decode_attention_all_empty_cache_is_finite():
    """All-empty cache: the -1e30 mask keeps the softmax finite (uniform
    weights), as the reference's guard test requires."""
    B, H, kv, hd, C = 1, 2, 2, 64, 128
    rng = np.random.default_rng(9)
    q = _rand(rng, (B, 1, H, hd))
    k = np.zeros((B, C, kv, hd), np.float32)
    v = _rand(rng, (B, C, kv, hd))
    kpos = np.full((B, C), -1, np.int32)
    pos = np.zeros((B,), np.int32)
    got = tops.decode_attention(*[torch.from_numpy(a) for a in
                                  (q, k, v, kpos, pos)], None, 0.125)
    assert bool(torch.isfinite(got).all())
    want = jops.decode_attention(*[jnp.asarray(a) for a in
                                   (q, k, v, kpos, pos)], None, 0.125)
    _close(got, want, ATTN_ATOL)


@pytest.mark.parametrize("H,kv,hd", [(4, 2, 64), (8, 4, 256), (48, 1, 128)])
def test_decode_attention_all_empty_row_at_c_100_matches_the_oracle(H, kv,
                                                                    hd):
    """A C of 100 slots (not a multiple of the kernel's block) with row 0
    all empty: the row weighs its 100 slots uniformly, as the JAX oracle
    does on the same cache, and the kernel's padding slots get no weight.
    (The Pallas wrapper pads C to its block and weighs its padding too, so
    only the oracle applies.)"""
    q, k, v, kpos, pos = _da_inputs(2, H, kv, hd, 100, seed=hd, empty=30)
    kpos[0] = -1
    pos[0] = 0
    tda.reset_counts()
    got = tops.decode_attention(*[torch.from_numpy(a) for a in
                                  (q, k, v, kpos, pos)], None, 0.125)
    assert tda.plain_calls == {"decode_attention": 1}
    want = jref.decode_attention_ref(*[jnp.asarray(a) for a in
                                       (q, k, v, kpos, pos)], None, 0.125)
    _close(got, want, ATTN_ATOL)
    # the row is the mean of its 100 V rows
    _close(got[0, 0].reshape(kv, H // kv, hd),
           np.broadcast_to(v[0].mean(axis=0)[:, None], (kv, H // kv, hd)),
           ATTN_ATOL)


def test_decode_attention_wrapper_checks_its_inputs():
    q, k, v, kpos, pos = (torch.from_numpy(a) for a in
                          _da_inputs(1, 4, 2, 64, 64))
    with pytest.raises(ValueError):
        tda.decode_attention(q[:, :, :3], k, v, kpos, pos, None, 0.1)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, v[:, :32], kpos, pos, None, 0.1)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, v, kpos[:, :5], pos, None, 0.1)
    with pytest.raises(ValueError):
        tda.decode_attention(q, k, v, kpos, pos, 0, 0.1)
    # the split depends on C, G and hd alone: SPLIT_C slots in the register
    # and shared-memory forms; in the tiled form at most TILED_SPLITS splits
    # of at least TILED_SPLIT_C slots up to SLICED_ROWS rows per CTA, and
    # TILED_WIDE_SPLIT_C slots above
    import inspect
    assert list(inspect.signature(tda.splits).parameters) == ["C", "G", "hd"]
    assert tda.splits(4096, 12, 128) == 16 and tda.splits(100, 12, 128) == 1
    assert tda.splits(512, 4, 100) == 2
    assert (tda.TILED_SPLIT_C, tda.TILED_SPLITS, tda.TILED_WIDE_SPLIT_C) \
        == (128, 8, 64)
    assert tda.split_c(1024, 2, 256) == 128 and tda.splits(1024, 2, 256) == 8
    assert tda.split_c(2048, 2, 256) == 256 and tda.splits(2048, 2, 256) == 8
    assert tda.split_c(1088, 2, 256) == 160 and tda.splits(1088, 2, 256) == 7
    assert tda.splits(160, 2, 256) == 2 and tda.splits(32, 2, 256) == 1
    assert tda.splits(2048, 48, 128) == 32 and tda.splits(160, 48, 128) == 3
    assert tda.splits(2048, 8, 256) == 8 and tda.splits(2048, 9, 256) == 32
    assert all(tda.split_c(C, G, hd) % tda.BLOCK_C == 0
               for C in range(32, 5000, 32) for G, hd in
               [(2, 256), (48, 128), (12, 128), (4, 100)])


def test_decode_attention_limits_equal_the_kernel_source():
    """The wrapper's constants are the CUDA source's; a head_dim above the
    kernel's limit is the plain version's on the CPU and matches the JAX
    oracle (the raise for CUDA tensors is the ``cuda`` test below)."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tda.__file__), "csrc",
                            "decode_attention.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert tda.BLOCK_C == const("kTile") == 32
    assert tda.MAX_HD == const("kMaxHd") == 256
    assert tda.REG_MAX_G == const("kRegG") == 32
    assert tda.REG_MAX_HD == const("kRegHd") == 128
    assert tda.REG_HD_MULTIPLE == const("kRegHdMultiple") == 8
    assert tda.TILED_HD_MULTIPLE == const("kTiledHdMultiple") == 8
    assert tda.TILED_ROWS == const("kTiledRows") == 64
    assert tda.SLICED_ROWS == const("kSlicedRows") == 8
    assert not hasattr(tda, "MAX_G") and "kMaxG" not in src
    ok = [torch.from_numpy(a) for a in _da_inputs(1, 48, 1, 256, 64)]
    assert tops.decode_attention(*ok, None, 0.1).shape == (1, 1, 48, 256)
    arrs = _da_inputs(1, 2, 1, 264, 64)
    tda.reset_counts()
    got = tda.decode_attention(*[torch.from_numpy(a) for a in arrs], None,
                               0.1)
    assert tda.plain_calls == {"decode_attention": 1}
    _close(got, jref.decode_attention_ref(*[jnp.asarray(a) for a in arrs],
                                          None, 0.1), ATTN_ATOL)


def test_decode_attention_form_matches_the_kernel_source():
    """``form()`` mirrors the source's ``register_form`` then
    ``tiled_form``: the register form for G <= kRegG and hd <= kRegHd with
    hd a multiple of kRegHdMultiple, the tiled form for every other (G, hd)
    with hd a multiple of kTiledHdMultiple, the shared-memory form for the
    rest."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tda.__file__), "csrc",
                            "decode_attention.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (tda.REG_MAX_G, tda.REG_MAX_HD, tda.REG_HD_MULTIPLE) == (
        const("kRegG"), const("kRegHd"), const("kRegHdMultiple"))
    assert tda.TILED_HD_MULTIPLE == const("kTiledHdMultiple")
    assert re.search(r"return G <= kRegG && hd <= kRegHd && "
                     r"hd % kRegHdMultiple == 0;", src)
    assert re.search(r"bool tiled_form\(int hd\) \{ return hd % "
                     r"kTiledHdMultiple == 0; \}", src)
    assert re.search(r"register_form\(G, hd\)\s*\?\s*launch_reg_form<T>"
                     r"[^;]*:\s*tiled_form\(hd\)\s*\?\s*launch_tiled_form<T>"
                     r"[^;]*:\s*launch_split<T>", src)
    # slice C's heads, then the reference sweep's
    for G, hd in [(12, 128), (1, 64), (4, 64), (8, 128), (4, 80), (5, 96),
                  (32, 128)]:
        assert tda.form(G, hd) == "register", (G, hd)
    # gemma3-4b, granite-34b, past kRegG, past kRegHd, past kTiledRows
    for G, hd in [(2, 256), (48, 128), (33, 64), (4, 136), (70, 64)]:
        assert tda.form(G, hd) == "tiled", (G, hd)
    # head_dims off the 8-multiple, in and past the register form's range
    for G, hd in [(4, 100), (48, 100), (2, 250), (1, 4)]:
        assert tda.form(G, hd) == "shared", (G, hd)


def test_decode_attention_offset_k_view_on_cpu_runs_plain_version():
    """The register form's 16-byte alignment rule is the card's: on the
    CPU an offset (misaligned) k view still gives the plain result."""
    q, k, v, kpos, pos = (torch.from_numpy(a) for a in
                          _da_inputs(2, 24, 2, 128, 64, seed=4, empty=10))
    buf = torch.empty(k.numel() + 1, dtype=k.dtype)
    k_off = buf[1:].view(k.shape)
    k_off.copy_(k)
    assert k_off.data_ptr() % tda.ALIGN and k_off.is_contiguous()
    tda.reset_counts()
    got = tda.decode_attention(q, k_off, v, kpos, pos, 32, 0.1)
    want = tref.decode_attention_ref(q, k, v, kpos, pos, 32, 0.1)
    assert torch.equal(got, want)
    assert tda.plain_calls == {"decode_attention": 1}
    assert tda.launches == {"decode_attention": 0}


# -- the tiled form's decomposition, in plain torch ----------------------------

def _tiled_decomposition(q, k, v, kpos, pos, window, scale):
    """The decomposition ``csrc/decode_attention.cu``'s tiled form
    computes, in plain torch (f32), to hold its algebra against the
    oracles: the cache padded to a multiple of 32 slots as
    ``ops.decode_attention`` pads it for the kernel, the padding slots'
    logits -inf (no weight, even in an all-empty row: the kernel's
    ``C_live`` is the true C); splits of ``split_c(C, G, hd)`` slots in
    32-slot tiles; each
    tile's logits as partial dots over hd slices (16-byte chunk c in slice
    c % S: S = 8 at most SLICED_ROWS rows per CTA, else 1) added in slice
    order; an online softmax per tile; P.V in slot groups (4 at S = 8,
    else 1) added in slot-group order at the split's end; per split
    (m, l, acc); then the combine over the splits in order."""
    f32 = torch.float32
    B, _, H, hd = q.shape
    live, kv = k.shape[1], k.shape[2]
    G = H // kv
    assert tda.form(G, hd) == "tiled"
    pad = (-live) % tda.BLOCK_C
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
    C = live + pad
    sliced = min(G, tda.TILED_ROWS) <= tda.SLICED_ROWS
    S, SG = (8, 4) if sliced else (1, 1)
    vec = 16 // k.element_size()
    slice_of = (torch.arange(hd) // vec) % S                  # per element
    qg = q.to(f32).reshape(B, kv, G, hd)
    kk, vv = (t.to(f32).permute(0, 2, 1, 3) for t in (k, v))  # [B,kv,C,hd]
    sc = tda.split_c(C, G, hd)
    parts = []
    for s in range(tda.splits(C, G, hd)):
        m = torch.full((B, kv, G), -1e30)
        l = torch.zeros((B, kv, G))
        acc = torch.zeros((SG, B, kv, G, hd))
        for t0 in range(s * sc, min(C, (s + 1) * sc), tda.BLOCK_C):
            ks, vs = kk[:, :, t0:t0 + 32], vv[:, :, t0:t0 + 32]
            dot = None
            for x in range(S):
                sel = slice_of == x
                d = torch.einsum("bkgd,bktd->bkgt", qg[..., sel], ks[..., sel])
                dot = d if dot is None else dot + d
            kp = kpos[:, t0:t0 + 32]
            delta = pos[:, None] - kp
            valid = (kp >= 0) & (delta >= 0)
            if window is not None:
                valid &= delta < window
            x = torch.where(valid[:, None, None, :], dot * scale,
                            torch.tensor(-1e30))
            x = torch.where(torch.arange(t0, t0 + 32) < live, x,
                            torch.tensor(-torch.inf))
            m_cur = torch.maximum(m, x.amax(-1))
            p = torch.exp(x - m_cur[..., None])
            alpha = torch.exp(m - m_cur)
            l = l * alpha + p.sum(-1)
            m = m_cur
            for g in range(SG):
                t = slice(g * 32 // SG, (g + 1) * 32 // SG)
                acc[g] = acc[g] * alpha[..., None] + torch.einsum(
                    "bkgt,bktd->bkgd", p[..., t], vs[:, :, t])
        a = acc[0]
        for g in range(1, SG):
            a = a + acc[g]
        parts.append((m, l, a))
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L, A = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp(m - M)
        L, A = L + w * l, A + w[..., None] * a
    return (A / torch.clamp(L, min=1e-30)[..., None]).reshape(B, 1, H, hd)


# gemma3-4b's heads (G 2 at hd 256: warps slice hd, 4 slot groups) over
# splits of 128 slots with a last split of two tiles and over 7 splits of
# 160 with a last of four, and granite-34b's (G 48: one row group per warp)
# over splits of 64 with a last split of one; then gemma's heads at C 100,
# padded to 128 with 28 slots of no weight
TILED_GEOMETRY = [(2, 8, 4, 256, 320), (1, 8, 4, 256, 1088),
                  (2, 48, 1, 128, 160), (2, 8, 4, 256, 100)]


@pytest.mark.parametrize("B,H,kv,hd,C", TILED_GEOMETRY)
@pytest.mark.parametrize("window,empty", [(None, 50), (128, 50),
                                          (None, None)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiled_form_decomposition_matches_the_oracles(B, H, kv, hd, C,
                                                      window, empty, dtype):
    """The tiled form's decomposition against the JAX oracle and the
    Pallas kernel in interpret mode; ``empty=None`` is the all-empty cache
    (finite, uniform weights)."""
    q, k, v, kpos, pos = _da_inputs(B, H, kv, hd, C, seed=hd + C,
                                    empty=50 if empty is None else empty)
    if empty is None:
        kpos[:] = -1
        pos[:] = 0
    (qj, kj, vj), (qt, kt, vt) = _as(dtype, q, k, v)
    scale = 1.0 / np.sqrt(hd)
    tol = BF16_ATOL if dtype == "bf16" else ATTN_ATOL
    got = _tiled_decomposition(qt, kt, vt, torch.from_numpy(kpos),
                               torch.from_numpy(pos), window, scale)
    assert bool(torch.isfinite(got).all())
    _close(got, jref.decode_attention_ref(qj, kj, vj, jnp.asarray(kpos),
                                          jnp.asarray(pos), window, scale),
           tol)
    if empty is None and C % min(jda.BLOCK_C, C):
        # the Pallas wrapper pads C to its block, and an all-empty cache
        # weighs the padding slots too: there only the oracle applies
        return
    _close(got, jops.decode_attention(qj, kj, vj, jnp.asarray(kpos),
                                      jnp.asarray(pos), window, scale), tol)


# -- the CUDA kernel against its plain version (needs a card) ------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,kv,hd,C", SWEEP + [(8, 24, 2, 128, 4096),
                                                 (4, 48, 1, 128, 2048),
                                                 (4, 8, 4, 256, 2048)])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_matches_plain_version(cuda_device, B, H, kv,
                                                     hd, C, window, dtype):
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in _da_inputs(B, H, kv, hd, C, seed=C)]
    q, k, v = (a.to(dtype) for a in arrs[:3])
    tda.reset_counts()
    out = tops.decode_attention(q, k, v, arrs[3], arrs[4], window, 0.1)
    torch.cuda.synchronize()
    assert tda.launches == {"decode_attention": 1}
    want = tref.decode_attention_ref(q, k, v, arrs[3], arrs[4], window, 0.1)
    tol = BF16_ATOL if dtype == torch.bfloat16 else ATTN_ATOL
    assert (out.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("H,kv,hd,C", [(24, 2, 128, 4096), (48, 1, 128, 2048),
                                       (8, 4, 256, 2048)])
def test_cuda_decode_attention_is_batch_invariant(cuda_device, H, kv, hd, C):
    q, k, v, kpos, pos = (torch.from_numpy(a).to(cuda_device)
                          for a in _da_inputs(8, H, kv, hd, C, seed=1))
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device) \
        * (400 * C // 4096) + 100
    full = tda.decode_attention(q, k, v, kpos, pos, None, 0.1)
    one = tda.decode_attention(q[3:4], k[3:4], v[3:4], kpos[3:4], pos[3:4],
                               None, 0.1)
    assert torch.equal(full[3:4], one)


# register form at slice C's heads: one tile (nothing to prefetch), a last
# split of one tile, a last split of five tiles
@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 288, 672])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_register_form_edge_cs(cuda_device, C, window,
                                                     dtype):
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in _da_inputs(2, 24, 2, 128, C, seed=C, empty=C // 4)]
    q, k, v = (a.to(dtype) for a in arrs[:3])
    assert tda.form(12, 128) == "register"
    tda.reset_counts()
    out = tda.decode_attention(q, k, v, arrs[3], arrs[4], window, 0.1)
    torch.cuda.synchronize()
    assert tda.launches == {"decode_attention": 1}
    want = tref.decode_attention_ref(q, k, v, arrs[3], arrs[4], window, 0.1)
    tol = BF16_ATOL if dtype == torch.bfloat16 else ATTN_ATOL
    assert (out.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_decode_attention_register_form_batch_invariant_windowed(
        cuda_device):
    q, k, v, kpos, pos = (torch.from_numpy(a).to(cuda_device)
                          for a in _da_inputs(8, 24, 2, 128, 4096, seed=2))
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device) * 400 + 100
    full = tda.decode_attention(q, k, v, kpos, pos, 128, 0.1)
    one = tda.decode_attention(q[3:4], k[3:4], v[3:4], kpos[3:4], pos[3:4],
                               128, 0.1)
    assert torch.equal(full[3:4], one)


@pytest.mark.cuda
def test_cuda_decode_attention_raises_above_the_kernels_head_dim(
        cuda_device):
    q, k, v, kpos, pos = (torch.from_numpy(a).to(cuda_device)
                          for a in _da_inputs(1, 2, 1, 264, 64))
    tda.reset_counts()
    with pytest.raises(ValueError, match="limit of 256"):
        tda.decode_attention(q, k, v, kpos, pos, None, 0.1)
    assert tda.launches == {"decode_attention": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("H,kv,hd", [(24, 2, 128), (8, 4, 256), (8, 2, 100)])
@pytest.mark.parametrize("C", [100, 650])
def test_cuda_decode_attention_all_empty_row_padded_c(cuda_device, H, kv, hd,
                                                      C):
    """All-empty row 0 beside a filled row 1, C padded for the kernel: the
    padding slots get no weight (the plain version runs unpadded)."""
    q, k, v, kpos, pos = _da_inputs(2, H, kv, hd, C, seed=C, empty=30)
    kpos[0] = -1
    pos[0] = 0
    arrs = [torch.from_numpy(a).to(cuda_device) for a in (q, k, v, kpos, pos)]
    out = tops.decode_attention(*arrs, None, 0.1)
    want = tref.decode_attention_ref(*arrs, None, 0.1)
    assert (out - want).abs().max().item() <= ATTN_ATOL


@pytest.mark.cuda
def test_cuda_decode_attention_misaligned_k_raises(cuda_device):
    q, k, v, kpos, pos = (torch.from_numpy(a).to(cuda_device)
                          for a in _da_inputs(2, 24, 2, 128, 64, seed=3))
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda_device)
    k_off = buf[1:].view(k.shape)
    k_off.copy_(k)
    tda.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tda.decode_attention(q, k_off, v, kpos, pos, None, 0.1)
    assert tda.launches == {"decode_attention": 0}


# tiled form at gemma3-4b's and granite-34b's heads: one tile (nothing to
# prefetch), a last split of one tile (splits of 128 and 64 slots)
@pytest.mark.cuda
@pytest.mark.parametrize("H,kv,hd,C", [(8, 4, 256, 32), (8, 4, 256, 160),
                                       (48, 1, 128, 32), (48, 1, 128, 96)])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_tiled_form_edge_cs(cuda_device, H, kv, hd, C,
                                                  window, dtype):
    arrs = [torch.from_numpy(a).to(cuda_device)
            for a in _da_inputs(2, H, kv, hd, C, seed=C, empty=C // 4)]
    q, k, v = (a.to(dtype) for a in arrs[:3])
    assert tda.form(H // kv, hd) == "tiled"
    tda.reset_counts()
    out = tda.decode_attention(q, k, v, arrs[3], arrs[4], window, 0.1)
    torch.cuda.synchronize()
    assert tda.launches == {"decode_attention": 1}
    want = tref.decode_attention_ref(q, k, v, arrs[3], arrs[4], window, 0.1)
    tol = BF16_ATOL if dtype == torch.bfloat16 else ATTN_ATOL
    assert (out.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("H,kv,hd", [(48, 1, 128), (8, 4, 256)])
def test_cuda_decode_attention_tiled_form_batch_invariant_windowed(
        cuda_device, H, kv, hd):
    q, k, v, kpos, pos = (torch.from_numpy(a).to(cuda_device)
                          for a in _da_inputs(8, H, kv, hd, 2048, seed=2))
    pos = torch.arange(8, dtype=torch.int32, device=cuda_device) * 200 + 100
    full = tda.decode_attention(q, k, v, kpos, pos, 128, 0.1)
    one = tda.decode_attention(q[3:4], k[3:4], v[3:4], kpos[3:4], pos[3:4],
                               128, 0.1)
    assert torch.equal(full[3:4], one)


@pytest.mark.cuda
@pytest.mark.parametrize("H,kv,hd", [(48, 1, 128), (8, 4, 256)])
def test_cuda_decode_attention_tiled_form_misaligned_k_raises(cuda_device, H,
                                                              kv, hd):
    q, k, v, kpos, pos = (torch.from_numpy(a).to(cuda_device)
                          for a in _da_inputs(2, H, kv, hd, 64, seed=3))
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda_device)
    k_off = buf[1:].view(k.shape)
    k_off.copy_(k)
    tda.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tda.decode_attention(q, k_off, v, kpos, pos, None, 0.1)
    assert tda.launches == {"decode_attention": 0}
