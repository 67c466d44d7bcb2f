"""The port's training path against the JAX package on the CPU:
``train/optimizer.py``, ``launch/steps.py``, ``train/loop.py``,
``train/checkpoint.py``, ``launch/train.py`` with ``sharding.py``'s
``param_shardings`` / ``batch_shardings``, and ``transformer``'s
activation checkpointing (remat).

Bars, float32 on the CPU:

* ``schedule``: 1e-6 relative over every step.  Both packages compute in
  float32, but an ulp of cos differs between XLA's and PyTorch's, and the
  (1 + cos) term's cancellation near the end of the cosine magnifies it
  (up to 5.4e-7 here); the reference's own jitted and eager schedules
  differ by 2.7e-7 there.
* ``apply_updates`` on equal gradients: params, mu and nu within 1e-6 of
  each leaf's largest magnitude (an element of mu near zero can lose its
  relative digits to cancellation), stats within 1e-6 relative.
* Two train steps from equal weights: the loss and grad norm within 1e-5
  relative; the gradients then differ by ``test_torch_loss.py``'s margin,
  so the moments are held within 1e-4 of their L2 norm (its gradient
  bar) and the params within 1e-5 of theirs: Adam's first steps map a
  gradient near zero to +-lr by its sign, so no elementwise bar holds.
* Remat on against off: bit for bit.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # network-less CI image: degrade to fixed examples
    from _hypothesis_compat import given, settings, st

from repro import sharding as JSH
from repro.configs import registry as jreg
from repro.data import pipeline as jdata
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import transformer as JT
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as JO
from repro_torch import sharding as TSH
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core.graph import tree_flatten_with_path, tree_leaves, \
    tree_map
from repro_torch.data import pipeline as tdata
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as TO

torch.set_num_threads(1)

ARCHS = sorted(jreg.ARCHS)
OPTS = [dict(lr=1e-3, warmup_steps=10, total_steps=100),
        dict(lr=2e-3, warmup_steps=3, total_steps=25), dict()]
SCHED_REL = 1e-6
OPT_REL = 1e-6
LOSS_REL = 1e-5
MOMENT_REL = 1e-4
PARAM_REL = 1e-5

_j_init = jax.jit(JT.init_lm, static_argnums=(0,))
_j_sched = jax.jit(jax.vmap(JO.schedule, in_axes=(None, 0)),
                   static_argnums=(0,))
_j_apply = jax.jit(JO.apply_updates, static_argnums=(3,))


@functools.cache
def _jparams(arch):
    return jax.tree_util.tree_map(
        np.array, _j_init(jreg.get_smoke(arch), jax.random.PRNGKey(0)))


def _pairs(jtree, ttree):
    """(reference leaf, port leaf) as numpy, in sorted-key order."""
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jtree)]
    tl = [t.detach().numpy() for t in tree_leaves(ttree)]
    assert len(jl) == len(tl)
    return zip(jl, tl)


def _close_to_scale(jtree, ttree, rel):
    for a, b in _pairs(jtree, ttree):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= rel * np.abs(a).max(), \
            np.abs(a - b).max()


def _close_in_norm(jtree, ttree, rel):
    for a, b in _pairs(jtree, ttree):
        assert np.linalg.norm(a - b) <= rel * np.linalg.norm(a)


# -- optimizer -----------------------------------------------------------------

@pytest.mark.parametrize("kw", OPTS, ids=["w10", "w3", "default"])
def test_schedule_matches_the_reference(kw):
    j, t = JO.OptConfig(**kw), TO.OptConfig(**kw)
    steps = np.arange(t.total_steps + 1, dtype=np.int32)
    want = np.asarray(_j_sched(j, jnp.asarray(steps)))
    got = TO.schedule(t, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SCHED_REL, atol=0)
    assert float(TO.schedule(t, 7)) == float(got[7])


def test_schedule_shape():
    cfg = TO.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                       min_lr_frac=0.1)
    lrs = [float(TO.schedule(cfg, s)) for s in range(100)]
    assert lrs[0] < lrs[9]
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[99] < lrs[50] < lrs[11]
    assert lrs[99] >= 0.1 * 1e-3 - 1e-12


@settings(max_examples=20, deadline=None)
@given(st.lists(st.floats(-100, 100), min_size=1, max_size=8))
def test_global_norm_matches_the_reference_and_numpy(vals):
    a = np.asarray(vals, np.float32)
    got = float(TO.global_norm({"a": torch.from_numpy(a),
                                "b": [torch.from_numpy(a[::-1].copy())]}))
    want = float(JO.global_norm({"a": jnp.asarray(a),
                                 "b": [jnp.asarray(a[::-1].copy())]}))
    np.testing.assert_allclose(got, np.linalg.norm(np.concatenate([a, a])),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_apply_updates_three_steps_match_the_reference():
    """Three AdamW steps on the starcoder2 smoke tree with seeded
    gradients, in place, against the reference's jitted update."""
    jp = _jparams("starcoder2-3b")
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        jp) for _ in range(3)]
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstate, jpp = JO.init_opt_state(jp), jax.tree_util.tree_map(jnp.asarray,
                                                                jp)
    tp = TT.params_from_jax(jp, "cpu")
    tstate = TO.init_opt_state(tp)
    mu = tstate["mu"]
    for g in grads:
        jpp, jstate, js = _j_apply(jpp, jax.tree_util.tree_map(jnp.asarray, g),
                                   jstate, JO.OptConfig(**kw))
        out_p, out_state, ts = TO.apply_updates(
            tp, TT.params_from_jax(g, "cpu"), tstate, TO.OptConfig(**kw))
        assert out_p is tp and out_state is tstate and tstate["mu"] is mu
        assert set(ts) == set(js) == {"grad_norm", "lr"}
        for k in js:
            assert abs(float(ts[k]) - float(js[k])) \
                <= OPT_REL * abs(float(js[k])), k
    assert tstate["step"].dtype == torch.int32 and tstate["step"].dim() == 0
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _close_to_scale(jpp, tp, OPT_REL)
    _close_to_scale(jstate["mu"], tstate["mu"], OPT_REL)
    _close_to_scale(jstate["nu"], tstate["nu"], OPT_REL)


def test_update_does_not_depend_on_the_chunking(monkeypatch):
    """The in-place update runs each leaf in slices of ``CHUNK`` values:
    any slicing gives the same bits."""
    cfg = treg.get_smoke("starcoder2-3b")
    g = TT.init_lm(cfg, 1, device="cpu")
    outs = []
    for chunk in (TO.CHUNK, 1000, 4096 * 3 + 5):
        monkeypatch.setattr(TO, "CHUNK", chunk)
        p = TT.init_lm(cfg, 0, device="cpu")
        state = TO.init_opt_state(p)
        for _ in range(2):
            TO.apply_updates(p, g, state, TO.OptConfig(lr=1e-3,
                                                       warmup_steps=1))
        outs.append(tree_leaves(p) + tree_leaves(state["nu"]))
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))


def test_decay_reaches_stacked_norm_scales_only_in_both_packages():
    """Weight decay applies to leaves of ndim >= 2: the stacked per-layer
    norm scales [L, d] are decayed, ``final_ln.scale`` [d] is not, in
    either package (zero gradients: only decay moves a parameter)."""
    jp = _jparams("starcoder2-3b")
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.5)
    zeros = jax.tree_util.tree_map(np.zeros_like, jp)
    jnew, _, _ = _j_apply(jax.tree_util.tree_map(jnp.asarray, jp),
                          jax.tree_util.tree_map(jnp.asarray, zeros),
                          JO.init_opt_state(jp), JO.OptConfig(**kw))
    tp = TT.params_from_jax(jp, "cpu")
    TO.apply_updates(tp, TT.params_from_jax(zeros, "cpu"),
                     TO.init_opt_state(tp), TO.OptConfig(**kw))
    ln_j = np.asarray(jnew["units"]["pos0"]["attn"]["ln"]["scale"])
    ln_t = tp["units"]["pos0"]["attn"]["ln"]["scale"].numpy()
    assert ln_t.shape == (2, 256)
    np.testing.assert_array_equal(ln_t, ln_j)
    assert np.all(ln_t < 1.0)                       # decayed: 1 - lr * wd
    np.testing.assert_allclose(ln_t, 1 - 1e-2 * 0.5, rtol=1e-6)
    fin_j = np.asarray(jnew["final_ln"]["scale"])
    fin_t = tp["final_ln"]["scale"].numpy()
    assert fin_t.shape == (256,)
    np.testing.assert_array_equal(fin_t, fin_j)
    np.testing.assert_array_equal(fin_t, np.ones(256, np.float32))


def test_grad_clip_caps_update():
    params = {"w": torch.ones((4, 4))}
    huge = {"w": torch.full((4, 4), 1e6)}
    state = TO.init_opt_state(params)
    before = params["w"].clone()
    cfg = TO.OptConfig(lr=1.0, clip_norm=1.0, warmup_steps=1, total_steps=10,
                       weight_decay=0.0)
    new, state, stats = TO.apply_updates(params, huge, state, cfg)
    assert float(stats["grad_norm"]) > 1e5
    assert float((new["w"] - before).abs().max()) <= 1.0 + 1e-5


def test_opt_state_is_on_the_params_device_and_float32():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": {"c": torch.ones(2, 2)}}
    s = TO.init_opt_state(p)
    assert s["mu"]["a"].dtype == torch.float32
    assert s["nu"]["b"]["c"].shape == (2, 2)
    assert s["mu"]["a"] is not s["nu"]["a"]
    assert s["step"].dtype == torch.int32


# -- remat -----------------------------------------------------------------------

REMAT_ARCHS = ["starcoder2-3b", "dbrx-132b", "mamba2-2.7b", "zamba2-2.7b",
               "seamless-m4t-large-v2", "gemma3-4b"]


def _grads(cfg, batch, params):
    (loss, _), grads = tloop.value_and_grad(
        lambda p: TT.loss_fn(p, cfg, batch), params)
    return loss, tree_leaves(grads)


def _tbatch(cfg, seed=0, B=2, S=16):
    it = tdata.make_lm_iter(cfg, B, S, seed=seed, prefetch=0)
    return tsteps.batch_to(next(it), torch.device("cpu"))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_equal_those_without_it(arch, policy):
    base = treg.get_smoke(arch)
    batch = _tbatch(base)
    off = dataclasses.replace(base, remat=False)
    on = dataclasses.replace(base, remat=True, remat_policy=policy)
    l0, g0 = _grads(off, batch, TT.init_lm(off, 0, device="cpu"))
    l1, g1 = _grads(on, batch, TT.init_lm(on, 0, device="cpu"))
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _mm_count(cfg, batch, params) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        _grads(cfg, batch, params)
    return Count.n


def test_remat_policies_recompute_what_they_say():
    """"full" runs every unit's matmuls again in the backward pass; "dots"
    keeps their outputs, so it runs no more matmuls than no remat."""
    base = treg.get_smoke("starcoder2-3b")
    batch = _tbatch(base)
    counts = {}
    for name, kw in (("off", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = dataclasses.replace(base, **kw)
        counts[name] = _mm_count(cfg, batch, TT.init_lm(cfg, 0, device="cpu"))
    assert counts["dots"] == counts["off"] < counts["full"], counts


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(treg.get_smoke("starcoder2-3b"),
                              remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        _grads(cfg, _tbatch(cfg), TT.init_lm(cfg, 0, device="cpu"))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_serving_outputs_do_not_depend_on_remat(arch):
    """forward, prefill and decode_step give the same bits with remat on
    and off, with and without grad enabled (the serving paths run without
    grad; remat acts only under it)."""
    base = treg.get_smoke(arch)
    b = _tbatch(base, B=2, S=12)
    kw = {k: v for k, v in b.items() if k.endswith("_embeds")}
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        p = TT.init_lm(cfg, 0, device="cpu")
        with torch.no_grad():
            logits, aux = TT.forward(p, cfg, b["tokens"], **kw)
            last, caches = TT.prefill(p, cfg, b["tokens"], max_len=16, **kw)
            tok = last.argmax(-1).to(torch.int32)
            step, _ = TT.decode_step(p, cfg, tok, torch.full((2,), 12,
                                                             dtype=torch.int32),
                                     caches)
        fwd_grad, _ = TT.forward(p, cfg, b["tokens"], **kw)
        outs.append((logits, last, step, fwd_grad.detach()))
    for a, c in zip(*outs):
        assert torch.equal(a, c)


def test_moe_dispatch_record_counts_one_dispatch_per_layer_under_recompute():
    cfg = treg.get_smoke("dbrx-132b")
    assert cfg.remat and cfg.remat_policy == "full"
    p = TT.init_lm(cfg, 0, device="cpu")
    batch = _tbatch(cfg)
    tmoe.reset_dispatch_record()
    tmoe.routing_log = []
    try:
        _grads(cfg, batch, p)
        log = tmoe.routing_log
    finally:
        tmoe.routing_log = None
    assert sum(r["dispatches"] for r in tmoe.dispatch_record.values()) \
        == cfg.num_layers
    assert len(log) == cfg.num_layers


# -- steps and the loop ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2-3b", "dbrx-132b"])
def test_train_step_two_steps_match_the_reference(arch):
    cfg, tcfg = jreg.get_smoke(arch), treg.get_smoke(arch)
    jp = _jparams(arch)
    it = jdata.make_lm_iter(cfg, 4, 16, seed=1, prefetch=0)
    batches = [next(it) for _ in range(2)]
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(cfg, JO.OptConfig(**kw)))
    tstep = tsteps.make_train_step(tcfg, TO.OptConfig(**kw))
    jstate, jpp = JO.init_opt_state(jp), jax.tree_util.tree_map(jnp.asarray,
                                                                jp)
    tp = TT.params_from_jax(jp, "cpu")
    tstate = TO.init_opt_state(tp)
    for b in batches:
        jpp, jstate, jm = jstep(jpp, jstate,
                                {k: jnp.asarray(v) for k, v in b.items()})
        tp, tstate, tm = tstep(tp, tstate, b)
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) \
                <= LOSS_REL * abs(float(jm[k])), k
    _close_in_norm(jstate["mu"], tstate["mu"], MOMENT_REL)
    _close_in_norm(jstate["nu"], tstate["nu"], MOMENT_REL)
    _close_in_norm(jpp, tp, PARAM_REL)


def test_prefill_and_serve_steps_are_prefill_and_decode_step():
    cfg = treg.get_smoke("starcoder2-3b")
    p = TT.init_lm(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32))
    with torch.no_grad():
        last, caches = tsteps.make_prefill_step(cfg)(p, {"tokens": toks})
        want_last, want_caches = TT.prefill(p, cfg, toks)
        assert torch.equal(last, want_last)
        for a, b in zip(tree_leaves(caches), tree_leaves(want_caches)):
            assert torch.equal(a, b)
        tok = last.argmax(-1).to(torch.int32)
        pos = torch.full((2,), 9, dtype=torch.int32)
        c1 = tree_map(torch.clone, caches)
        step, _ = tsteps.make_serve_step(cfg)(p, tok, pos, caches)
        want, _ = TT.decode_step(p, cfg, tok, pos, c1)
        assert torch.equal(step, want)
    assert tsteps.step_for(cfg, "prefill").__name__ == "prefill_step"
    assert tsteps.step_for(cfg, "decode").__name__ == "serve_step"
    assert tsteps.step_for(cfg, "train").__name__ == "train_step"


def test_train_loop_loss_drops_with_the_reference_history_keys():
    """The reference test's settings (``tests/test_train_data.py``): 25
    steps of the starcoder2 smoke config, the loss down by > 0.3; the
    history's keys are the reference loop's."""
    cfg = treg.get_smoke("starcoder2-3b")
    it = tdata.make_lm_iter(cfg, batch=8, seq_len=32, seed=0)
    opt = TO.OptConfig(lr=2e-3, warmup_steps=3, total_steps=25)
    seen = []
    _, state, hist = tloop.train(cfg, opt, it, num_steps=25, log_every=24,
                                 callback=seen.append, device="cpu")
    assert [h["step"] for h in hist] == [0, 24] and seen == hist
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3
    assert int(state["step"]) == 25
    jcfg = jreg.get_smoke("starcoder2-3b")
    _, _, jhist = jloop.train(jcfg, JO.OptConfig(), jdata.make_lm_iter(
        jcfg, 2, 8, seed=0, prefetch=0), num_steps=1)
    assert sorted(hist[0]) == sorted(jhist[0])


def test_train_loop_takes_a_generator_key_and_given_params():
    cfg = treg.get_smoke("starcoder2-3b")
    opt = TO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    runs = []
    for key in (np.random.default_rng(3), 3):
        it = tdata.make_lm_iter(cfg, 2, 8, seed=0, prefetch=0)
        p, _, h = tloop.train(cfg, opt, it, 2, key=key, log_every=1,
                              device="cpu")
        runs.append((tree_leaves(p), h))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    p0 = TT.init_lm(cfg, 3, device="cpu")
    it = tdata.make_lm_iter(cfg, 2, 8, seed=0, prefetch=0)
    p, _, h = tloop.train(cfg, opt, it, 2, params=p0, log_every=1)
    assert p is p0
    assert [m["loss"] for m in h] == [m["loss"] for m in runs[0][1]]


def test_train_loop_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = treg.get_smoke("starcoder2-3b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.train(cfg, TO.OptConfig(), iter([]), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run("starcoder2-3b", 1, 2, 8)


# -- checkpoints -------------------------------------------------------------------

def _tree_np():
    return {"a": {"b": np.arange(1000, dtype=np.float32).reshape(10, 100)},
            "c": [np.ones(3, np.int32), np.zeros((2, 2), np.float64)]}


def _shard_keys(out: str) -> dict:
    names = sorted(f for f in os.listdir(out) if f.startswith("shard"))
    keys = {}
    for n in names:
        with np.load(os.path.join(out, n)) as z:
            keys[n] = sorted(z.files)
    return keys


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference saves and the port restores; the port saves and the
    reference restores: equal values, the same manifest and the same
    shard split at shard_bytes=1024."""
    tree = _tree_np()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jout = jckpt.save(jdir, 5, tree, shard_bytes=1024)
    ttree = tree_map(torch.from_numpy, tree)
    tout = tckpt.save(tdir, 5, ttree, shard_bytes=1024)
    with open(os.path.join(jout, "manifest.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tout, "manifest.json")) as f:
        tm = json.load(f)
    assert tm == jm and jm["shards"] > 1
    assert _shard_keys(tout) == _shard_keys(jout)
    like_t = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                            device="meta"), ttree)
    like_j = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    back_t = tckpt.restore(jdir, 5, like_t, device="cpu")
    back_j = jckpt.restore(tdir, 5, like_j)
    for a, b, c in zip(jax.tree_util.tree_leaves(tree), tree_leaves(back_t),
                       jax.tree_util.tree_leaves(back_j)):
        assert b.dtype == torch.from_numpy(a).dtype and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), a)
        np.testing.assert_array_equal(np.asarray(c), a)
    assert tckpt.latest_step(tdir) == jckpt.latest_step(tdir) == 5
    tckpt.save(tdir, 12, ttree)
    assert tckpt.latest_step(tdir) == 12
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def test_model_checkpoint_crosses_both_ways(tmp_path):
    """The starcoder2 smoke parameters: the reference's tree restored by
    the port into real tensors (their dtype kept), and back."""
    jp = _jparams("starcoder2-3b")
    jckpt.save(str(tmp_path / "j"), 3, jp, shard_bytes=1 << 20)
    like = TT.init_lm(treg.get_smoke("starcoder2-3b"), 1, device="cpu")
    back = tckpt.restore(str(tmp_path / "j"), 3, like)
    for a, b in _pairs(jp, back):
        np.testing.assert_array_equal(b, a)
    tckpt.save(str(tmp_path / "t"), 3, back, shard_bytes=1 << 20)
    jlike = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jp)
    jback = jckpt.restore(str(tmp_path / "t"), 3, jlike)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(jback)):
        np.testing.assert_array_equal(np.asarray(b), a)


def test_restore_checks_shapes(tmp_path):
    tckpt.save(str(tmp_path), 1, {"w": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="checkpoint"):
        tckpt.restore(str(tmp_path), 1, {"w": torch.ones(3, 2)})


# -- the launcher, its mesh and shardings ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_batch_shardings_equal_the_reference(arch):
    """Over the reference's 1 x 1 host mesh and the port's one-device
    mesh: the same specs for every parameter and batch leaf."""
    jm = jmesh.make_host_mesh()
    tm = tmesh.make_data_model_mesh(device="cpu")
    assert tuple(jm.axis_names) == tm.axis_names
    assert dict(jm.shape) == tm.shape
    jcfg = jreg.get_smoke(arch)
    jp = JT.abstract_params(jcfg, jnp.float32)
    tp = TT.abstract_params(treg.get_smoke(arch), torch.float32)

    def norm(spec):
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)

    js = {jax.tree_util.keystr(p): norm(s.spec) for p, s in
          jax.tree_util.tree_flatten_with_path(
              JSH.param_shardings(jp, jm))[0]}
    ts = {"".join(f"['{k}']" for k in p): norm(s.spec) for p, s in
          _flat_shardings(TSH.param_shardings(tp, tm))}
    assert ts == js
    batch = next(jdata.make_lm_iter(jcfg, 2, 8, prefetch=0))
    jb = {jax.tree_util.keystr(p): norm(s.spec) for p, s in
          jax.tree_util.tree_flatten_with_path(
              JSH.batch_shardings(batch, jm))[0]}
    tb = {"".join(f"['{k}']" for k in p): norm(s.spec) for p, s in
          _flat_shardings(TSH.batch_shardings(batch, tm))}
    assert tb == jb


def _flat_shardings(tree, path=()):
    if isinstance(tree, TSH.NamedSharding):
        yield path, tree
        return
    for k in sorted(tree):
        yield from _flat_shardings(tree[k], path + (k,))


def test_mesh_is_one_device_and_device_put_places_every_leaf():
    m = tmesh.make_data_model_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmesh.make_data_model_mesh(model=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmesh.DeviceMesh(torch.device("cpu"), sizes=(2, 1))
    batch = next(tdata.make_lm_iter(treg.get_smoke("starcoder2-3b"), 2, 8,
                                    prefetch=0))
    placed = TSH.device_put(batch, TSH.batch_shardings(batch, m))
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in placed.values())
    np.testing.assert_array_equal(placed["tokens"].numpy(), batch["tokens"])
    p = TT.init_lm(treg.get_smoke("starcoder2-3b"), 0, device="cpu")
    same = TSH.device_put(p, TSH.param_shardings(p, m))
    assert all(a is b for a, b in zip(tree_leaves(p), tree_leaves(same)))


def test_launcher_runs_with_the_reference_log_keys(capsys):
    """``run`` on the CPU: finite losses, a line per logged step, and the
    reference launcher's history keys (the weights differ: numpy draws
    here, a JAX key there, so the numbers are held through
    ``launch.steps`` on equal weights above)."""
    params, hist = ttrain.run("starcoder2-3b", steps=3, batch=2, seq=8,
                              log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert out.count("step ") == 3 and "loss=" in out
    _, jhist = jtrain.run("starcoder2-3b", steps=1, batch=2, seq=8)
    assert sorted(hist[0]) == sorted(jhist[0])
    assert tree_leaves(params)[0].device.type == "cpu"


def test_launcher_saves_and_resumes(tmp_path, capsys):
    """40 steps with a checkpoint every 20, then 20 more: the second run
    resumes from step 40 with the saved parameters bit for bit, logs
    steps 40-59 and saves step 60.  As the reference does, it restores
    the parameters only (queue 3 items 15 and 16)."""
    d = str(tmp_path / "ck")
    p40, h1 = ttrain.run("starcoder2-3b", steps=40, batch=2, seq=8,
                         ckpt_dir=d, ckpt_every=20, log_every=1,
                         device="cpu")
    assert sorted(os.listdir(d)) == ["step_20", "step_40"]
    assert "resumed" not in capsys.readouterr().out
    like = TT.abstract_params(treg.get_smoke("starcoder2-3b"), torch.float32)
    saved = tckpt.restore(d, 40, like, device="cpu")
    for a, b in zip(tree_leaves(p40), tree_leaves(saved)):
        assert torch.equal(a.detach(), b)
    restored = []
    orig = tckpt.restore

    def spy(*a, **k):
        out = orig(*a, **k)
        restored.append(tree_map(torch.clone, out))   # trained in place
        return out

    import repro_torch.launch.train as lt
    lt.ckpt.restore = spy
    try:
        _, h2 = ttrain.run("starcoder2-3b", steps=20, batch=2, seq=8,
                           ckpt_dir=d, log_every=1, device="cpu")
    finally:
        lt.ckpt.restore = orig
    assert "resumed from step 40" in capsys.readouterr().out
    assert [h["step"] for h in h2] == list(range(40, 60))
    assert tckpt.latest_step(d) == 60
    for a, b in zip(tree_leaves(restored[0]), tree_leaves(saved)):
        assert torch.equal(a, b)
    # the schedule restarts: step 40's lr is the first run's step 0 lr
    assert h2[0]["lr"] == h1[0]["lr"] < h1[1]["lr"]


def test_launcher_main_parses_the_reference_flags_and_device(monkeypatch):
    seen = {}
    monkeypatch.setattr(ttrain, "run", lambda *a, **k: seen.update(a=a, k=k))
    ttrain.main(["--arch", "starcoder2-3b", "--steps", "7", "--batch", "2",
                 "--seq", "16", "--ckpt-dir", "x", "--lr", "0.01",
                 "--device", "cpu"])
    assert seen["a"] == ("starcoder2-3b", 7, 2, 16)
    assert seen["k"] == dict(smoke=True, ckpt_dir="x", lr=0.01, device="cpu")


def test_reduced_depth_keeps_the_tree():
    """The card-vs-CPU step of ``chip_smoke.py`` cuts StarCoder2-3B to 2
    layers at full width: the same tree as the smoke config's, wider."""
    full = dataclasses.replace(treg.get_config("starcoder2-3b"), num_layers=2)
    a = TT.abstract_params(full, torch.float32)
    b = TT.abstract_params(treg.get_smoke("starcoder2-3b"), torch.float32)
    assert [p for p, _ in tree_flatten_with_path(a)] == \
        [p for p, _ in tree_flatten_with_path(b)]
    assert TT.param_count(a) == full.param_count() == 342_899_712
    assert tbase.reduced(full).num_layers == 2
