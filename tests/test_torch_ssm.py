"""Slice D's SSD scan and Mamba2 block in the port against the JAX reference:
the plain scan (``ssd_scan_ref``), the kernel wrapper's CPU path
(``ops.ssd_scan``) against the Pallas kernel in interpret mode, the CUDA
kernel's chunk-parallel decomposition written in plain torch against both
oracles, ``ssd_chunked`` with ragged and short prompts, and ``mamba_block`` /
``mamba_decode`` / ``_causal_conv`` on carried weights and caches.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the wrapper runs its plain version; the CUDA kernel is held
against it in the ``cuda`` tests, which skip without a card
(``chip_smoke.py`` runs the same checks there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

# the reference sweep's own bars (tests/test_kernels.py): f32 sums in
# another order, and bf16 inputs
F32_ATOL = 1e-4
BF16_ATOL = 5e-2
# a whole Mamba2 block or step in f32: projections and the scan
BLOCK_ATOL = 2e-5

# (B, nc, Q, H, P, N): the reference's sweep (tests/test_kernels.py)
SWEEP = [(1, 2, 16, 2, 16, 8), (2, 4, 32, 3, 32, 16), (1, 8, 64, 2, 64, 64)]


def _scan_inputs(B, nc, Q, H, P, N, seed, dt=(0.001, 0.1)):
    """Seeded scan inputs as numpy float32: x, dt, A, B, C, init state."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, nc, Q, H, P)).astype(f),
            rng.uniform(*dt, (B, nc, Q, H)).astype(f),
            -rng.uniform(0.5, 1.5, (H,)).astype(f),
            rng.standard_normal((B, nc, Q, N)).astype(f),
            rng.standard_normal((B, nc, Q, N)).astype(f),
            rng.standard_normal((B, H, P, N)).astype(f))


def _as(arrs, dtype):
    """numpy f32 scan inputs -> (jax, torch) with x/B/C in ``dtype`` (bf16
    rounded once, by JAX, and handed to torch exactly)."""
    x, dt, A, Bm, Cm, st = arrs
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jB, jC = (jnp.asarray(a, jd) for a in (x, Bm, Cm))
    j = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(st))
    t = tuple(torch.from_numpy(np.asarray(a, np.float32).copy()) for a in j)
    t = (t[0].to(dtype), t[1], t[2], t[3].to(dtype), t[4].to(dtype), t[5])
    return j, t


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=rtol)


# -- the scan ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_ref_matches_jax_ref(shape, dtype):
    j, t = _as(_scan_inputs(*shape, seed=sum(shape)), dtype)
    y, fin = tref.ssd_scan_ref(*t)
    yj, fj = jref.ssd_scan_ref(*j)
    assert y.dtype == dtype and fin.dtype == torch.float32
    tol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    _close(y, yj, tol)
    _close(fin, fj, tol, rtol=1e-3)


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_ssd_scan_matches_pallas_interpret(shape, dtype):
    """The wrapper's CPU path (the plain version) against the Pallas kernel
    run in interpret mode, as the reference's own sweep runs it."""
    j, t = _as(_scan_inputs(*shape, seed=sum(shape)), dtype)
    tssd.reset_counts()
    y, fin = tops.ssd_scan(*t)
    yj, fj = jops.ssd_scan(*j)
    B, nc, Q, H, P, _ = shape
    assert tuple(y.shape) == (B, nc * Q, H, P) == tuple(yj.shape)
    assert tssd.plain_calls == {"ssd_scan": 1}
    assert tssd.launches == {"ssd_scan": 0}
    tol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    _close(y, yj, tol)
    _close(fin, fj, tol, rtol=1e-3)


def test_ssd_scan_state_chaining():
    """Scanning 4 chunks at once == two 2-chunk calls chained via state,
    and both equal the reference's chained calls."""
    x, dt, A, Bm, Cm, _ = _scan_inputs(1, 4, 16, 2, 16, 8, seed=5,
                                       dt=(0.01, 0.1))
    st0 = np.zeros((1, 2, 16, 8), np.float32)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, st0)]
    y_all, f_all = tops.ssd_scan(*t)
    first = [a[:, :2] for a in (t[0], t[1])] + [t[2]] \
        + [a[:, :2] for a in (t[3], t[4])]
    second = [a[:, 2:] for a in (t[0], t[1])] + [t[2]] \
        + [a[:, 2:] for a in (t[3], t[4])]
    y1, f1 = tops.ssd_scan(*first, t[5])
    y2, f2 = tops.ssd_scan(*second, f1)
    _close(y_all, torch.cat([y1, y2], dim=1).numpy(), F32_ATOL)
    _close(f_all, f2.numpy(), F32_ATOL)
    yj, fj = jops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, st0)))
    _close(y_all, yj, F32_ATOL)
    _close(f_all, fj, F32_ATOL, rtol=1e-3)


def test_large_decay_is_finite_where_the_pallas_kernel_is_nan():
    """A chunk whose sum of dt*|A| passes ~88 (Q=64, dt=3, A=-1): the Pallas
    kernel forms exp(cum_i - cum_j) above the diagonal before masking it,
    overflows to inf and gives inf*0 = NaN in y (its final state, whose
    exponents are <= 0, stays finite).  The reference's plain oracle masks
    first and is finite; so is the port, and it agrees with the oracle.
    ROADMAP queue 3 item 3."""
    B, nc, Q, H, P, N = 1, 1, 64, 2, 16, 8
    x, _, _, Bm, Cm, st = _scan_inputs(B, nc, Q, H, P, N, seed=3)
    dt = np.full((B, nc, Q, H), 3.0, np.float32)
    A = -np.ones((H,), np.float32)
    args = (x, dt, A, Bm, Cm, st)
    yp, fp = jops.ssd_scan(*(jnp.asarray(a) for a in args))
    assert bool(jnp.isnan(yp).any())
    assert bool(jnp.isfinite(fp).all())
    yj, fj = jref.ssd_scan_ref(*(jnp.asarray(a) for a in args))
    assert bool(jnp.isfinite(yj).all())
    t = [torch.from_numpy(a) for a in args]
    for y, fin in (tref.ssd_scan_ref(*t), tops.ssd_scan(*t)):
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
        _close(y.reshape(yj.shape), yj, F32_ATOL)
        _close(fin, fj, F32_ATOL, rtol=1e-3)


# -- the CUDA kernel's decomposition, in plain torch --------------------------

def _chunk_parallel_scan(xc, dtc, A, Bc, Cc, init_state):
    """The chunk-parallel form ``csrc/ssd_scan.cu`` computes, written in
    plain torch (f32) to hold its algebra against the oracles: (1) C.B^T
    once per (b, chunk), not per head; (2) each chunk's own contribution to
    the state, per (b, chunk, head); (3) the only sequential part, a pass
    over the chunks that keeps the state entering each; (4) each chunk's
    output from C.B and that state.  The causal mask comes before the
    exp."""
    f32 = torch.float32
    x, dt, Bm, Cm = (t.to(f32) for t in (xc, dtc, Bc, Cc))
    Q = x.shape[2]
    cum = torch.cumsum(dt * A.to(f32), dim=2)                   # [B,nc,Q,H]
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)                 # (1)
    w = dt * torch.exp(cum[:, :, -1:] - cum)
    local = torch.einsum("bcthp,bcth,bctn->bchpn", x, w, Bm)     # (2)
    decay = torch.exp(cum[:, :, -1])                            # [B,nc,H]
    state, entering = init_state.to(f32), []
    for c in range(x.shape[1]):                                 # (3)
        entering.append(state)
        state = state * decay[:, c, :, None, None] + local[:, c]
    s_prev = torch.stack(entering, dim=1)                       # [B,nc,H,P,N]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,nc,i,j,H]
    scores = cb[..., None] * dt[:, :, None] * torch.exp(
        torch.where(causal[None, None, :, :, None], diff, -torch.inf))
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, x) \
        + torch.einsum("bcin,bchpn->bcihp", Cm, s_prev) \
        * torch.exp(cum)[..., None]                              # (4)
    return y.to(xc.dtype), state


# the reference sweep, then a ragged chunk of Q = 100 whose last chunk ends
# in dt = 0 pad rows (x, B, C zero too), as ``ssd_chunked`` pads a prompt
DECOMP_CASES = [(s, "sweep") for s in SWEEP] + [((2, 3, 100, 4, 16, 8), "pad")]
PAD_FROM = 63


@pytest.mark.parametrize("shape,kind", DECOMP_CASES)
def test_chunk_parallel_decomposition_matches_the_oracles(shape, kind):
    arrs = _scan_inputs(*shape, seed=sum(shape) + 1)
    if kind == "pad":
        for a in (arrs[0], arrs[1], arrs[3], arrs[4]):
            a[:, -1, PAD_FROM:] = 0.0
    t = [torch.from_numpy(a) for a in arrs]
    y, fin = _chunk_parallel_scan(*t)
    yj, fj = jref.ssd_scan_ref(*(jnp.asarray(a) for a in arrs))
    yt, ft = tref.ssd_scan_ref(*t)
    for want_y, want_f in ((yj, fj), (yt.numpy(), ft.numpy())):
        _close(y, want_y, F32_ATOL)
        _close(fin, want_f, F32_ATOL, rtol=1e-3)
    if kind == "pad":
        # the pad rows leave the state as the unpadded tokens leave it:
        # one step at a time, s = s exp(dt A) + dt x B^T
        x, dt, A, Bm, _, st = arrs
        B, nc, Q, H, P, N = shape
        s = torch.from_numpy(st).double()
        for c in range(nc):
            for q in range(PAD_FROM if c == nc - 1 else Q):
                d = torch.from_numpy(dt[:, c, q]).double()        # [B,H]
                s = s * torch.exp(d * torch.from_numpy(A).double()
                                  )[:, :, None, None] \
                    + torch.einsum("bh,bhp,bn->bhpn", d,
                                   torch.from_numpy(x[:, c, q]).double(),
                                   torch.from_numpy(Bm[:, c, q]).double())
        _close(fin, s.float().numpy(), F32_ATOL, rtol=1e-3)


def test_chunk_parallel_decomposition_large_decay_is_finite():
    """dt = 3 over chunks of 64 (a chunk's sum of dt*|A| is 192): the
    decomposition masks before the exp, so y and the state stay finite and
    agree with the JAX oracle."""
    B, nc, Q, H, P, N = 1, 2, 64, 2, 16, 8
    x, _, _, Bm, Cm, st = _scan_inputs(B, nc, Q, H, P, N, seed=9)
    dt = np.full((B, nc, Q, H), 3.0, np.float32)
    A = -np.ones((H,), np.float32)
    args = (x, dt, A, Bm, Cm, st)
    y, fin = _chunk_parallel_scan(*(torch.from_numpy(a) for a in args))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    yj, fj = jref.ssd_scan_ref(*(jnp.asarray(a) for a in args))
    _close(y, yj, F32_ATOL)
    _close(fin, fj, F32_ATOL, rtol=1e-3)


@pytest.mark.parametrize("S,chunk", [(100, 32), (20, 32), (64, 32), (7, 64)])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_matches_jax(S, chunk, use_kernel):
    """Ragged S (padded with dt = 0 rows), S < chunk (one chunk of Q = S)
    and an exact multiple, with and without the kernel path."""
    rng = np.random.default_rng(S + chunk)
    B, H, P, N = 2, 3, 16, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 1.5, (H,)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    st = rng.standard_normal((B, H, P, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm)
    y, fin = tssm.ssd_chunked(*(torch.from_numpy(a) for a in args), chunk,
                              init_state=torch.from_numpy(st),
                              use_kernel=use_kernel)
    yj, fj = jssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk,
                              init_state=jnp.asarray(st),
                              use_kernel=use_kernel)
    assert tuple(y.shape) == (B, S, H, P)
    _close(y, yj, F32_ATOL)
    _close(fin, fj, F32_ATOL, rtol=1e-3)


# -- the Mamba2 block ------------------------------------------------------------

SPEC = tssm.MambaSpec(64, SSMConfig(state_dim=16, head_dim=32, expand=2,
                                    chunk=32))
JSPEC = jssm.MambaSpec(64, JSSMConfig(state_dim=16, head_dim=32, expand=2,
                                      chunk=32))
# the reference's block functions, compiled once (op by op they take
# seconds on the CPU)
_j_init = jax.jit(jssm.init_mamba, static_argnums=(1, 2))
_j_block = jax.jit(jssm.mamba_block, static_argnums=(1,),
                   static_argnames=("use_kernel",))
_j_decode = jax.jit(jssm.mamba_decode, static_argnums=(1,))


def _block_params(seed):
    """The reference's init_mamba, with A_log, D, dt_bias and the norm
    scales drawn too (its init sets them to constants), as numpy."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        np.asarray, _j_init(jax.random.PRNGKey(seed), JSPEC, jnp.float32))
    H = JSPEC.n_heads
    p["A_log"] = (0.5 * rng.standard_normal(H)).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    p["dt_bias"] = (0.5 * rng.standard_normal(H)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)
                   ).astype(np.float32)
    for k in ("ln", "norm"):
        p[k] = {"scale": rng.uniform(0.5, 1.5, p[k]["scale"].shape
                                     ).astype(np.float32)}
    return p


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def test_init_mamba_has_the_reference_tree():
    got = tssm.init_mamba(np.random.default_rng(0), SPEC, np.float32)
    want = _j_init(jax.random.PRNGKey(0), JSPEC, jnp.float32)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(got) == shapes(want)
    assert tssm.mamba_param_count(SPEC) == jssm.mamba_param_count(JSPEC) \
        == sum(a.size for a in jax.tree_util.tree_leaves(got))
    assert tssm.mamba_flops(SPEC, 1000) == jssm.mamba_flops(JSPEC, 1000)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(4)
    ch = SPEC.conv_channels
    x = rng.standard_normal((2, 9, ch)).astype(np.float32)
    w = rng.standard_normal((4, ch)).astype(np.float32)
    b = rng.standard_normal(ch).astype(np.float32)
    st = rng.standard_normal((2, 3, ch)).astype(np.float32) if with_state \
        else None
    out, new = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b),
                                 None if st is None else torch.from_numpy(st))
    outj, newj = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if st is None else jnp.asarray(st))
    _close(out, outj, 1e-6)
    assert torch.equal(new, torch.from_numpy(np.array(newj)))


@pytest.mark.parametrize("S", [64, 45])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_matches_jax(S, use_kernel):
    p = _block_params(S)
    x = (np.random.default_rng(S).standard_normal((2, S, 64))
         ).astype(np.float32)
    got = tssm.mamba_block(_torch_tree(p), SPEC, torch.from_numpy(x),
                           use_kernel=use_kernel)
    want = _j_block(jax.tree_util.tree_map(jnp.asarray, p), JSPEC,
                    jnp.asarray(x), use_kernel=use_kernel)
    _close(got, want, BLOCK_ATOL)


def test_mamba_decode_matches_jax_on_a_carried_cache():
    """Three steps from the same random conv and SSM state in both packages;
    the port's new caches equal the reference's."""
    p = _block_params(7)
    rng = np.random.default_rng(7)
    cache = {"conv": rng.standard_normal((2, 3, SPEC.conv_channels)
                                         ).astype(np.float32),
             "ssd": rng.standard_normal((2, SPEC.n_heads, 32, 16)
                                        ).astype(np.float32)}
    pt, pj = _torch_tree(p), jax.tree_util.tree_map(jnp.asarray, p)
    ct, cj = _torch_tree(cache), jax.tree_util.tree_map(jnp.asarray, cache)
    for step in range(3):
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        yt, ct = tssm.mamba_decode(pt, SPEC, torch.from_numpy(x), ct)
        yj, cj = _j_decode(pj, JSPEC, jnp.asarray(x), cj)
        _close(yt, yj, BLOCK_ATOL)
        _close(ct["conv"], cj["conv"], BLOCK_ATOL)     # holds a projection
        _close(ct["ssd"], cj["ssd"], BLOCK_ATOL, rtol=1e-5)


def test_prefill_state_then_decode_equals_the_longer_prefill():
    """The chunked scan's final state, stepped by ``mamba_decode``, gives
    what the block computes over the longer sequence (port alone)."""
    p = _torch_tree(_block_params(11))
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (1, 41, 64)).astype(np.float32))
    full = tssm.mamba_block(p, SPEC, x)
    h = tlayers.rmsnorm(p["ln"], x[:, :40])
    _, xBC, dt_raw = tssm._split_proj(SPEC, h @ p["in_proj"])
    xBC, conv = tssm._causal_conv(xBC, p["conv_w"], p["conv_b"])
    di, N = SPEC.d_inner, 16
    dt = torch.nn.functional.softplus(dt_raw + p["dt_bias"])
    _, state = tssm.ssd_chunked(xBC[..., :di].reshape(1, 40, SPEC.n_heads, 32),
                                dt, -torch.exp(p["A_log"]),
                                xBC[..., di:di + N], xBC[..., di + N:], 32)
    last, _ = tssm.mamba_decode(p, SPEC, x[:, 40:], {"conv": conv,
                                                     "ssd": state})
    _close(last, full[:, 40:].numpy(), BLOCK_ATOL)


def test_init_mamba_cache_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tssm.init_mamba_cache(SPEC, 2, torch.float32)
    c = tssm.init_mamba_cache(SPEC, 2, torch.float32, device="cpu")
    assert tuple(c["conv"].shape) == (2, 3, SPEC.conv_channels)
    assert tuple(c["ssd"].shape) == (2, SPEC.n_heads, 32, 16)
    assert c["ssd"].dtype == torch.float32


# -- the wrapper's checks -------------------------------------------------------

def _wrapper_args():
    return [torch.from_numpy(a) for a in
            _scan_inputs(1, 2, 16, 2, 16, 8, seed=0)]


@pytest.mark.parametrize("bad", ["dt", "A", "B", "init", "x_rank"])
def test_wrapper_refuses_wrong_shapes(bad):
    x, dt, A, Bm, Cm, st = _wrapper_args()
    if bad == "dt":
        dt = dt[..., :1]
    elif bad == "A":
        A = A[:1]
    elif bad == "B":
        Bm = Bm[:, :1]
    elif bad == "init":
        st = st[..., :4]
    else:
        x = x[0]
    with pytest.raises(ValueError):
        tssd.ssd_scan(x, dt, A, Bm, Cm, st)


@pytest.mark.parametrize("bad", ["x_f16", "B_mixed", "dt_bf16", "init_f64"])
def test_wrapper_refuses_wrong_dtypes(bad):
    x, dt, A, Bm, Cm, st = _wrapper_args()
    if bad == "x_f16":
        x, Bm, Cm = x.half(), Bm.half(), Cm.half()
    elif bad == "B_mixed":
        Bm = Bm.to(torch.bfloat16)
    elif bad == "dt_bf16":
        dt = dt.to(torch.bfloat16)
    else:
        st = st.double()
    with pytest.raises(TypeError):
        tssd.ssd_scan(x, dt, A, Bm, Cm, st)


def test_wrapper_refuses_non_contiguous_inputs():
    x, dt, A, Bm, Cm, st = _wrapper_args()
    xt = x.transpose(3, 4).contiguous().transpose(3, 4)
    assert not xt.is_contiguous() and torch.equal(xt, x)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_scan(xt, dt, A, Bm, Cm, st)
    # the ops wrapper hands the kernel contiguous copies
    y, _ = tops.ssd_scan(xt, dt, A, Bm, Cm, st)
    assert torch.equal(y, tops.ssd_scan(x, dt, A, Bm, Cm, st)[0])


@pytest.mark.parametrize("where", ["all_meta", "mixed"])
def test_wrapper_refuses_devices_it_does_not_run_on(where):
    args = _wrapper_args()
    if where == "all_meta":
        args = [a.to("meta") for a in args]
    else:
        args[3] = args[3].to("meta")
    tssd.reset_counts()
    with pytest.raises(ValueError, match="cuda device"):
        tssd.ssd_scan(*args)
    assert tssd.plain_calls == {"ssd_scan": 0}


def test_ssd_limits_equal_the_kernel_source():
    """The wrapper's limits are the CUDA source's."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tssd.__file__), "csrc",
                            "ssd_scan.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert tssd.MAX_Q == const("kMaxQ") == 256
    assert tssd.MAX_P == const("kMaxP") == 64
    assert tssd.MAX_N == const("kMaxN") == 128


# -- the CUDA kernel against its plain version (needs a card) ------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP + [(4, 8, 256, 80, 64, 128),
                                           (2, 1, 100, 4, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_scan_matches_plain_version(cuda_device, shape, dtype):
    _, t = _as(_scan_inputs(*shape, seed=1), dtype)
    t = [a.to(cuda_device) for a in t]
    tssd.reset_counts()
    y, fin = tssd.ssd_scan(*t)
    torch.cuda.synchronize()
    assert tssd.launches == {"ssd_scan": 1}
    yr, fr = tref.ssd_scan_ref(*t)
    tol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    assert (y.float() - yr.float()).abs().max().item() <= tol
    assert ((fin - fr).abs() <= tol + 1e-3 * fr.abs()).all()


@pytest.mark.cuda
def test_cuda_ssd_scan_large_decay_is_finite(cuda_device):
    x, _, _, Bm, Cm, st = _scan_inputs(1, 1, 64, 2, 16, 8, seed=3)
    dt = np.full((1, 1, 64, 2), 3.0, np.float32)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (x, dt, -np.ones(2, np.float32), Bm, Cm, st)]
    y, fin = tssd.ssd_scan(*t)
    yr, fr = tref.ssd_scan_ref(*t)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
    assert (y - yr).abs().max().item() <= F32_ATOL


@pytest.mark.cuda
def test_cuda_ssd_scan_state_chaining(cuda_device):
    """4 chunks in one kernel call == two calls of 2 chunks chained through
    the state, within the f32 bar."""
    arrs = _scan_inputs(1, 4, 64, 8, 64, 128, seed=6, dt=(0.01, 0.1))
    x, dt, A, Bm, Cm, st = (torch.from_numpy(a).to(cuda_device) for a in arrs)
    y_all, f_all = tssd.ssd_scan(x, dt, A, Bm, Cm, st)
    half = [[t[:, sl].contiguous() for t in (x, dt, Bm, Cm)]
            for sl in (slice(0, 2), slice(2, 4))]
    y1, f1 = tssd.ssd_scan(half[0][0], half[0][1], A, half[0][2], half[0][3],
                           st)
    y2, f2 = tssd.ssd_scan(half[1][0], half[1][1], A, half[1][2], half[1][3],
                           f1)
    torch.cuda.synchronize()
    assert (y_all - torch.cat([y1, y2], dim=1)).abs().max().item() <= F32_ATOL
    assert (f_all - f2).abs().max().item() <= F32_ATOL


@pytest.mark.cuda
def test_cuda_ssd_scan_counts_one_launch_per_call(cuda_device):
    """One wrapper call at Mamba2-2.7B's prefill shape launches the kernel's
    phases and counts once; the plain version does not run."""
    _, t = _as(_scan_inputs(4, 8, 256, 80, 64, 128, seed=2), torch.float32)
    t = [a.to(cuda_device) for a in t]
    tssd.reset_counts()
    y, fin = tssd.ssd_scan(*t)
    torch.cuda.synchronize()
    assert tssd.launches == {"ssd_scan": 1}
    assert tssd.plain_calls == {"ssd_scan": 0}
    assert tuple(y.shape) == (4, 8, 256, 80, 64)
    assert tuple(fin.shape) == (4, 80, 64, 128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(fin).all())
