"""The port's MoE block (``models/moe.py``) against the JAX package.

Inputs are drawn with numpy from a seed; the reference's weights come from
its own ``init_moe`` and are carried over with ``params_from_jax``.  The
reference's expert-parallel body ``moe_block_local`` runs under
``jax.vmap(..., axis_name="expert")`` on one CPU device (its
``all_to_all``s and ``axis_size`` work there), against the port's
one-process form over the same shards.

Routing decides which expert a token reaches, so every parity test asserts
that the routing indices equal the reference's, and states the smallest
gap between the k-th and (k+1)-th router probability of its inputs: a
gap near float rounding could rightly flip an index under another
summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JM
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

TOL = 1e-5
D, F_ = 64, 128


def _specs(E=4, k=2, cf=2.0, shards=0, d=D, f=F_, gated=True):
    return (JM.MoESpec(d, f, gated, JMoEConfig(E, k, cf, token_shards=shards)),
            TM.MoESpec(d, f, gated, MoEConfig(E, k, cf, token_shards=shards)))


def _params(js, seed=0):
    p = JM.init_moe(jax.random.PRNGKey(seed), js, jnp.float32)
    return p, TT.params_from_jax(jax.tree_util.tree_map(np.array, p), "cpu")


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _min_gap(p, js, h) -> float:
    """Smallest gap between the k-th and (k+1)-th router probability."""
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(h) @ p["router"], axis=-1)), axis=-1)[:, ::-1]
    k = js.moe.top_k
    if k == probs.shape[1]:
        return float("inf")
    return float((probs[:, k - 1] - probs[:, k]).min())


# -- capacity ---------------------------------------------------------------------

@pytest.mark.parametrize("E,k,cf", [(16, 4, 1.25), (128, 1, 1.25), (4, 2, 2.0),
                                    (16, 4, 8.0), (4, 2, 0.5), (3, 1, 1.1)])
def test_capacity_equals_the_reference(E, k, cf):
    """Over a table of token counts, boundary values included (2048 * 4 /
    16 * 1.25 = 640 exactly)."""
    js, ts = _specs(E, k, cf)
    for T in (1, 2, 3, 4, 7, 8, 16, 24, 100, 128, 256, 511, 512, 1024, 2048,
              2112, 4096, 8192):
        assert TM._capacity(T, ts) == JM._capacity(T, js), T


# -- routing and dispatch ------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(4, 2), (16, 4), (128, 1)])
def test_route_and_dispatch_indices_equal_the_reference(E, k):
    """Indices equal, gates and aux within 1e-6; the slot positions and the
    keep mask of a capacity that drops equal too.  Smallest top-k gap of
    these inputs: above 1e-5 at each (E, k)."""
    js, ts = _specs(E, k)
    p, tp = _params(js)
    h = _x((96, D))
    assert _min_gap(p, js, h) > 1e-5
    jidx, jg, jaux = JM._route(p, js, jnp.asarray(h))
    idx, g, aux = TM._route(tp, ts, torch.from_numpy(h))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    C = max(1, 96 * k // (2 * E))                 # half the mean: drops
    jf, jp, jk = JM.dispatch_indices(jidx, E, C)
    f, pos, keep = TM.dispatch_indices(idx, E, C)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jk))
    assert not keep.all()


def test_route_breaks_ties_to_the_lower_index_as_the_reference():
    """Exact ties (a zero router: every probability 1/E) pick the lowest
    indices in order, as ``jax.lax.top_k`` does; ``torch.topk`` would
    not promise it."""
    js, ts = _specs(16, 4, d=32)
    p, tp = _params(js)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    h = _x((8, 32))
    jidx, jg, _ = JM._route(p, js, jnp.asarray(h))
    idx, g, _ = TM._route(tp, ts, torch.from_numpy(h))
    assert np.asarray(jidx).tolist() == [[0, 1, 2, 3]] * 8
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=0)


# -- moe_block ---------------------------------------------------------------------

@pytest.mark.parametrize("cf,drops", [(8.0, False), (0.5, True)])
def test_moe_block_matches_the_reference(cf, drops):
    """No drop (cf 8.0) and a tight capacity (cf 0.5: the record shows the
    drops) within 1e-5, aux within 1e-6.  Smallest top-k gap: > 1e-5."""
    js, ts = _specs(4, 2, cf)
    p, tp = _params(js)
    x = _x((2, 16, D), scale=0.5)
    jy, jaux = jax.jit(lambda p, x: JM.moe_block(p, js, x))(p, jnp.asarray(x))
    TM.reset_dispatch_record()
    y, aux = TM.moe_block(tp, ts, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    C = TM._capacity(32, ts)
    rec = TM.dispatch_record
    assert list(rec) == [(32, C)] and rec[(32, C)]["assignments"] == 64
    assert (TM.dropped() > 0) == drops


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("shards", [2, 4])
def test_token_sharded_dispatch_matches_the_reference(shards, cf):
    """``token_shards`` 2 and 4: per-shard capacity buffers, with and
    without drops, against the reference's ``_moe_block_sharded``; with
    no drop, also the global dispatch's result."""
    js, ts = _specs(4, 2, cf, shards)
    p, tp = _params(js)
    x = _x((4, 16, D), seed=2, scale=0.5)
    jy, jaux = jax.jit(lambda p, x: JM.moe_block(p, js, x))(p, jnp.asarray(x))
    TM.reset_dispatch_record()
    y, aux = TM.moe_block(tp, ts, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    (T_l, C_l), = TM.dispatch_record
    assert T_l == 64 // shards and C_l == TM._capacity(T_l, ts)
    assert TM.dispatch_record[(T_l, C_l)]["dispatches"] == shards
    if TM.dropped() == 0:
        g, _ = TM.moe_block(tp, dataclasses.replace(
            ts, moe=dataclasses.replace(ts.moe, token_shards=0)),
            torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), g.numpy(), atol=TOL)
    else:
        assert cf == 0.5


# -- expert parallelism in one process --------------------------------------------

def _j_local(p, js, xs, ax):
    """The reference's per-device body on every expert shard at once."""
    E_l = js.moe.num_experts // ax
    sharded = {k: v.reshape((ax, E_l) + v.shape[1:])
               if k in ("up", "gate", "down") else v for k, v in p.items()}
    axes = {k: 0 if k in ("up", "gate", "down") else None for k in p}
    fn = jax.vmap(lambda pp, x: JM.moe_block_local(pp, js, x, "expert"),
                  in_axes=(axes, 0), axis_name="expert")
    return jax.jit(fn)(sharded, xs)


def _shards(tp, ax):
    E_l = tp["up"].shape[0] // ax
    return [{k: v[i * E_l:(i + 1) * E_l] if k in ("up", "gate", "down")
             else v for k, v in tp.items()} for i in range(ax)]


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("ax", [2, 4])
def test_moe_block_local_matches_the_reference_under_vmap(ax, cf):
    """dbrx's routing (16 experts, top-4) at small width over 2 and 4
    shards: each shard's output and aux equal the reference's on that
    device of the expert axis, within 1e-5 (cf 1.25 drops at some
    shards).  Smallest top-k gap: > 1e-5."""
    js, ts = _specs(16, 4, cf)
    p, tp = _params(js, seed=3)
    xs = _x((ax, 2, 8, D), seed=4, scale=0.5)
    for i in range(ax):
        assert _min_gap(p, js, xs[i].reshape(-1, D)) > 1e-5
    jy, jaux = _j_local(p, js, jnp.asarray(xs), ax)
    TM.reset_dispatch_record()
    ys, auxes = TM.moe_block_local(_shards(tp, ax), ts,
                                   [torch.from_numpy(x) for x in xs])
    for i in range(ax):
        np.testing.assert_allclose(ys[i].numpy(), np.asarray(jy[i]),
                                   atol=TOL)
        np.testing.assert_allclose(float(auxes[i]), float(jaux[i]),
                                   atol=1e-6)
    (T_l, C), = TM.dispatch_record
    assert TM.dispatch_record[(T_l, C)]["dispatches"] == ax
    if cf == 8.0:
        assert TM.dropped() == 0


def test_moe_block_local_equals_the_global_dispatch_without_drops():
    """At cf 8.0 nothing drops, so the shards' outputs together are
    ``moe_block`` over all their tokens (the reference's claim)."""
    js, ts = _specs(16, 4, 8.0)
    _, tp = _params(js, seed=5)
    xs = torch.from_numpy(_x((2, 2, 8, D), seed=6, scale=0.5))
    ys, _ = TM.moe_block_local(_shards(tp, 2), ts, list(xs))
    g, _ = TM.moe_block(tp, ts, xs.reshape(4, 8, D))
    np.testing.assert_allclose(torch.cat(ys).numpy(), g.numpy(), atol=TOL)


def test_moe_block_local_checks_its_shards():
    js, ts = _specs(16, 4, 8.0)
    _, tp = _params(js)
    with pytest.raises(ValueError, match="do not divide"):
        TM.moe_block_local([tp] * 3, ts, [torch.zeros(1, 4, D)] * 3)
    with pytest.raises(ValueError, match="one shape"):
        TM.moe_block_local(_shards(tp, 2), ts,
                           [torch.zeros(1, 4, D), torch.zeros(1, 6, D)])


def test_moe_flops_and_param_count_equal_the_reference():
    for E, k, cf, gated in ((16, 4, 1.25, True), (128, 1, 1.25, True),
                            (4, 2, 2.0, False)):
        js, ts = _specs(E, k, cf, d=6144, f=10752, gated=gated)
        assert TM.moe_flops(ts, 2048) == JM.moe_flops(js, 2048)
        assert TM.moe_param_count(ts) == JM.moe_param_count(js)
