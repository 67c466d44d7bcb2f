"""The port's LM zoo (``configs/``, ``models/transformer.py``) against the JAX
reference on every smoke config, the moe family's included: parameter
counts, ``forward`` logits (and the router's aux loss), ``prefill``
logits and caches, ``decode_step`` from the reference's own caches
carried over, and greedy tokens, each with ``use_kernel`` False and True;
the moe configs' routing indices equal the reference's in every entry
point.  ``abstract_params`` equals the reference's ``jax.eval_shape``
tree for every full config.  The decode tests also run two cases at
the zoo's widest attention heads (``WIDE``: gemma3-4b's hd 256,
granite-34b's 48 query heads over one kv head), at the same tolerance.

The reference's weights are carried over with ``params_from_jax``; its
functions are compiled once per config (op by op they take seconds on
the CPU).  On the CPU the port's kernel wrappers run their plain
versions; ``chip_smoke.py`` drives the kernels on the card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core.graph import tree_flatten_with_path
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

# the reference's own bar for decode against forward (tests/test_archs.py)
ATOL = 2e-4
B, S, NEW = 2, 12, 8
ARCHS = sorted(jreg.ARCHS)
PORTED = ARCHS
MOE = [a for a in ARCHS if jreg.get_smoke(a).moe is not None]
# the zoo's widest attention heads at smoke width, through the decode
# tests: gemma3-4b's 8 query over 4 kv heads of 256 (with its smoke
# (32, None) window pattern) and granite-34b's 48 query heads over one
WIDE = {"gemma3-4b/heads": ("gemma3-4b", dict(num_heads=8, kv_heads=4,
                                              head_dim=256)),
        "granite-34b/heads": ("granite-34b", dict(num_heads=48, kv_heads=1,
                                                  head_dim=128))}

_j_init = jax.jit(JT.init_lm, static_argnums=(0,))
_j_forward = jax.jit(JT.forward, static_argnames=("cfg", "use_kernel",
                                                  "unroll"))
_j_prefill = jax.jit(JT.prefill, static_argnames=("cfg", "max_len",
                                                  "use_kernel", "unroll"))
_j_decode = jax.jit(JT.decode_step, static_argnames=("cfg", "use_kernel",
                                                     "unroll"))


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _configs(arch):
    """(reference config, port config) of a case: an arch's smoke config,
    or a ``WIDE`` one."""
    if arch in WIDE:
        name, heads = WIDE[arch]
        return (jbase.reduced(jreg.get_config(name), **heads),
                tbase.reduced(treg.get_config(name), **heads))
    return jreg.get_smoke(arch), treg.get_smoke(arch)


@functools.cache
def _setup(arch):
    """The reference's weights and a seeded batch for one smoke config."""
    cfg = _configs(arch)[0]
    params = _j_init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    kw = {}
    if cfg.num_prefix_embeds:
        name = "encoder_embeds" if cfg.encoder_layers else "prefix_embeds"
        kw[name] = (0.05 * rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model))).astype(np.float32)
    return cfg, params, tokens, kw


@functools.cache
def _reference(arch, use_kernel):
    """Everything the tests compare, computed once by the reference.  The
    flag is passed on only where it reaches a kernel in the reference (the
    SSD scan in forward and prefill, decode attention in a step), so the
    compiled functions are shared where it reaches none."""
    cfg, params, tokens, kw = _setup(arch)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    scan_k = use_kernel and cfg.ssm is not None
    attn_k = use_kernel and cfg.family != "ssm"
    logits, aux = _j_forward(params, cfg, jnp.asarray(tokens),
                             use_kernel=scan_k, **jkw)
    last, caches = _j_prefill(params, cfg, jnp.asarray(tokens),
                              max_len=S + NEW, use_kernel=scan_k, **jkw)
    out = {"forward": np.array(logits), "aux": float(aux),
           "prefill": np.array(last), "caches": _np(caches)}
    # greedy decode, keeping every step's input token, logits and caches
    tok = jnp.argmax(last, -1).astype(jnp.int32)
    steps = []
    for i in range(NEW - 1):
        pos = jnp.full((B,), S + i, jnp.int32)
        lg, new = _j_decode(params, cfg, tok, pos, caches,
                            use_kernel=attn_k)
        steps.append({"token": np.array(tok), "logits": np.array(lg),
                      "caches_in": _np(caches), "caches_out": _np(new)})
        caches, tok = new, jnp.argmax(lg, -1).astype(jnp.int32)
    out["steps"] = steps
    return out


def _port(arch):
    cfg, params, tokens, kw = _setup(arch)
    return (_configs(arch)[1], TT.params_from_jax(_np(params), "cpu"),
            torch.from_numpy(tokens),
            {k: torch.from_numpy(v) for k, v in kw.items()})


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=rtol)


def _close_trees(got, want):
    gl = list(tree_flatten_with_path(got))
    wl = list(tree_flatten_with_path(want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert tuple(g.shape) == w.shape, path
        if w.dtype.kind in "iu":
            assert np.array_equal(g.numpy(), w), path
        else:
            # SSD states sum over a whole chunk: the reference sweep's
            # relative bar for final states (tests/test_kernels.py)
            _close(g, w, rtol=1e-3 if path[-1] == "ssd" else 0.0)


def _top2_margin(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


# -- configs ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for get in ("get_config", "get_smoke"):
        got, want = getattr(treg, get)(arch), getattr(jreg, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert (got.padded_vocab, got.unit_layers) == \
            (want.padded_vocab, want.unit_layers)
    assert treg.pair_supported(arch, "long_500k") == \
        jreg.pair_supported(arch, "long_500k")


def test_registry_and_input_shapes_equal_the_reference():
    assert treg.ARCHS == jreg.ARCHS and treg.LONG_CONTEXT_OK == \
        jreg.LONG_CONTEXT_OK
    assert treg.all_pairs() == jreg.all_pairs()
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    cfg = treg.get_config("mamba2-2.7b")
    got = tbase.reduced(cfg, num_layers=3, d_model=128)
    want = jbase.reduced(jreg.get_config("mamba2-2.7b"), num_layers=3,
                         d_model=128)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- parameters -------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_param_count_and_tree_match_the_reference(arch):
    cfg, params, _, _ = _setup(arch)
    tcfg = treg.get_smoke(arch)
    own = TT.init_lm(tcfg, 0, device="cpu")
    carried = TT.params_from_jax(_np(params), "cpu")
    assert TT.param_count(own) == TT.param_count(carried) \
        == JT.param_count(params) == tcfg.param_count()
    shapes = [(p, tuple(a.shape)) for p, a in tree_flatten_with_path(own)]
    want = [(p, tuple(a.shape)) for p, a in
            tree_flatten_with_path(_np(params))]
    assert shapes == want
    # padded vocab rows are zero, as in the reference's init
    assert not own["embed"]["table"][tcfg.vocab:].any()


@pytest.mark.parametrize("arch", PORTED)
def test_flops_estimate_matches_the_reference(arch):
    for kind in ("train", "prefill", "decode"):
        assert TT.flops_estimate(treg.get_smoke(arch), 2, 64, kind) == \
            JT.flops_estimate(jreg.get_smoke(arch), 2, 64, kind)
        assert TT.flops_estimate(treg.get_config(arch), 1, 4096, kind) == \
            JT.flops_estimate(jreg.get_config(arch), 1, 4096, kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference_eval_shape(arch):
    """Every full config's tree as meta tensors, leaf for leaf the
    reference's ``abstract_params`` (``jax.eval_shape``) in shape and
    dtype, at its default bfloat16 and at float32; nothing is drawn
    (dbrx-132b is 490 GiB in float32)."""
    for jdt, tdt in ((None, None), (jnp.float32, torch.float32)):
        want = JT.abstract_params(jreg.get_config(arch),
                                  *([jdt] if jdt else []))
        got = TT.abstract_params(treg.get_config(arch),
                                 *([tdt] if tdt else []))
        wl = [(p, tuple(a.shape), np.dtype(a.dtype).name)
              for p, a in tree_flatten_with_path(
                  jax.tree_util.tree_map(lambda a: a, want))]
        gl = [(p, tuple(a.shape), str(a.dtype).removeprefix("torch."))
              for p, a in tree_flatten_with_path(got)]
        assert gl == wl
        assert all(a.device.type == "meta" for _, a in
                   tree_flatten_with_path(got))
        assert TT.param_count(got) == treg.get_config(arch).param_count()


@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_carries_a_moe_tree(arch):
    """The reference's moe tree (router, experts' up / gate / down) comes
    over leaf for leaf, bit for bit, the router in float32 as the
    reference keeps it whatever the dtype."""
    cfg, params, _, _ = _setup(arch)
    got = TT.params_from_jax(_np(params), "cpu")
    want = list(tree_flatten_with_path(_np(params)))
    assert [p for p, _ in tree_flatten_with_path(got)] == [p for p, _ in want]
    for (path, g), (_, w) in zip(tree_flatten_with_path(got), want):
        assert np.array_equal(g.numpy(), w), path
    moe = got["units"]["pos0"]["moe"]
    E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    assert tuple(moe["up"].shape) == (cfg.num_layers, E, d, f)
    assert tuple(moe["down"].shape) == (cfg.num_layers, E, f, d)
    own = TT.init_lm(treg.get_smoke(arch), 0, dtype=torch.bfloat16,
                     device="cpu")
    assert own["units"]["pos0"]["moe"]["router"].dtype == torch.float32
    assert own["units"]["pos0"]["moe"]["up"].dtype == torch.bfloat16


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get_smoke("mamba2-2.7b")
    for fn in (lambda: TT.init_lm(cfg, 0),
               lambda: TT.init_caches(cfg, 1, 8),
               lambda: TT.params_from_jax({"a": np.zeros(2)}),
               lambda: TT.caches_from_jax({"a": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "gemma3-4b",
                                  "seamless-m4t-large-v2", "dbrx-132b"])
def test_init_caches_match_the_reference_tree(arch):
    got = TT.init_caches(treg.get_smoke(arch), 2, 24, device="cpu")
    want = _np(JT.init_caches(jreg.get_smoke(arch), 2, 24))
    _close_trees(got, want)


def test_params_from_jax_keeps_bfloat16_exactly():
    x = jnp.asarray(np.random.default_rng(0).standard_normal(64), jnp.bfloat16)
    got = TT.params_from_jax({"w": np.asarray(x)}, "cpu")["w"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(x, np.float32))


# -- forward / prefill / decode ----------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(arch, use_kernel):
    tcfg, tp, tokens, kw = _port(arch)
    want = _reference(arch, use_kernel)["forward"]
    logits, aux = TT.forward(tp, tcfg, tokens, use_kernel=use_kernel, **kw)
    assert tuple(logits.shape) == want.shape == (B, S, tcfg.padded_vocab)
    if tcfg.moe is None:
        assert float(aux) == 0.0
    else:                           # the router's load-balance loss
        assert abs(float(aux) - _reference(arch, use_kernel)["aux"]) <= 1e-6
    _close(logits, want)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_logits_and_caches_match_jax(arch, use_kernel):
    tcfg, tp, tokens, kw = _port(arch)
    ref = _reference(arch, use_kernel)
    tssd.reset_counts()
    last, caches = TT.prefill(tp, tcfg, tokens, max_len=S + NEW,
                              use_kernel=use_kernel, **kw)
    _close(last, ref["prefill"])
    _close_trees(caches, ref["caches"])
    mamba_layers = tcfg.num_layers if tcfg.ssm else 0
    assert tssd.plain_calls["ssd_scan"] == (mamba_layers if use_kernel else 0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", PORTED + list(WIDE))
def test_decode_step_from_carried_jax_caches(arch, use_kernel):
    """Every step of the reference's greedy decode, replayed by the port
    from the reference's own caches: logits and new caches agree."""
    tcfg, tp, _, _ = _port(arch)
    tda.reset_counts()
    for i, st in enumerate(_reference(arch, use_kernel)["steps"]):
        caches = TT.caches_from_jax(st["caches_in"], "cpu")
        pos = torch.full((B,), S + i, dtype=torch.int32)
        logits, new = TT.decode_step(tp, tcfg, torch.from_numpy(st["token"]),
                                     pos, caches, use_kernel=use_kernel)
        assert new is caches                      # updated in place
        _close(logits, st["logits"])
        _close_trees(new, st["caches_out"])
    attn_layers = 0 if tcfg.family == "ssm" else (
        tcfg.num_layers // tcfg.hybrid_unit if tcfg.hybrid_unit
        else tcfg.num_layers)
    assert tda.plain_calls["decode_attention"] == \
        (attn_layers * (NEW - 1) if use_kernel else 0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", PORTED + list(WIDE))
def test_greedy_tokens_match_jax(arch, use_kernel):
    """The port's own prefill and greedy decode give the reference's tokens.
    A token is held to equality while every earlier step's top-1/top-2
    margin in the reference exceeds 2 * ATOL (past a closer call the two
    may rightly part); the margins seen here all clear it."""
    tcfg, tp, tokens, kw = _port(arch)
    ref = _reference(arch, use_kernel)
    want = [np.argmax(ref["prefill"], -1)] + \
        [np.argmax(st["logits"], -1) for st in ref["steps"]]
    margins = [_top2_margin(ref["prefill"])] + \
        [_top2_margin(st["logits"]) for st in ref["steps"]]
    last, caches = TT.prefill(tp, tcfg, tokens, max_len=S + NEW,
                              use_kernel=use_kernel, **kw)
    got = [last.argmax(-1)]
    for i in range(NEW - 1):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        logits, caches = TT.decode_step(tp, tcfg, got[-1].to(torch.int32),
                                        pos, caches, use_kernel=use_kernel)
        got.append(logits.argmax(-1))
    assert min(float(m.min()) for m in margins) > 2 * ATOL
    assert [g.numpy().tolist() for g in got] == [w.tolist() for w in want]


# -- the moe family's routing ------------------------------------------------------

def _j_routing(monkeypatch) -> list:
    """Record the indices and the router's inputs of every ``_route`` call
    of the reference's moe module."""
    from repro.models import moe as JM
    seen, route = [], JM._route

    def recording(p, s, h):
        out = route(p, s, h)
        seen.append((np.asarray(out[0]), np.asarray(h),
                     np.asarray(p["router"]), s))
        return out

    monkeypatch.setattr(JM, "_route", recording)
    return seen


def _min_topk_gap(calls) -> float:
    gaps = []
    for _, h, router, s in calls:
        z = h.astype(np.float64) @ router
        p = np.exp(z - z.max(-1, keepdims=True))
        p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
        k = s.moe.top_k
        gaps.append(float((p[:, k - 1] - p[:, k]).min()))
    return min(gaps)


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_indices_equal_the_reference(arch, monkeypatch):
    """``forward``, ``prefill`` and one ``decode_step`` (from the
    reference's caches) route every token of every layer to the
    reference's experts, index for index.  The reference runs op by op
    (``unroll=True``) so its indices can be read; the port's are in its
    routing log.  Smallest top-k gap of these inputs: above 1e-4 for both
    moe smoke configs."""
    from repro_torch.models import moe as TM
    cfg, params, tokens, _ = _setup(arch)
    tcfg, tp, ttok, _ = _port(arch)
    st = _reference(arch, False)["steps"][0]       # compiled before
    want = _j_routing(monkeypatch)
    got = []
    monkeypatch.setattr(TM, "routing_log", got)
    pos = np.full((B,), S, np.int32)
    JT.forward(params, dataclasses.replace(cfg, remat=False),
               jnp.asarray(tokens), unroll=True)   # remat would trace
    JT.prefill(params, cfg, jnp.asarray(tokens), max_len=S + NEW, unroll=True)
    JT.decode_step(params, cfg, jnp.asarray(st["token"]), jnp.asarray(pos),
                   jax.tree_util.tree_map(jnp.asarray, st["caches_in"]),
                   unroll=True)
    TT.forward(tp, tcfg, ttok)
    TT.prefill(tp, tcfg, ttok, max_len=S + NEW)
    TT.decode_step(tp, tcfg, torch.from_numpy(st["token"]),
                   torch.from_numpy(pos),
                   TT.caches_from_jax(st["caches_in"], "cpu"))
    assert len(got) == len(want) == 3 * tcfg.num_layers
    for g, (w, *_) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert _min_topk_gap(want) > 1e-4
