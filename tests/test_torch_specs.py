"""The port's ``launch/specs.py`` and ``launch/mesh.py``'s shape-only meshes
against the JAX package's.

The specs read only a mesh's ``shape`` and ``axis_names``, so both
packages get the same plain stand-ins of the reference's 256- and 512-chip
production meshes (as ``tests/test_torch_sharding.py`` does); no device is
involved.  The reference's inputs are ``jax.eval_shape`` trees, the port's
meta tensors.  JAX's ``PartitionSpec`` writes a one-name tuple entry as
the name; the comparison reads both sides that way.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import specs as JS
from repro_torch import sharding as TSH
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as TS

torch.set_num_threads(1)

ARCHS = sorted(jreg.ARCHS)
SHAPES = sorted(jreg.INPUT_SHAPES)
KINDS = ("train", "prefill", "decode")
MESHES = {
    "pod": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model")),
    "multipod": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
}
# the decisions the port's 30e9 budget changes against the reference's
# 6e9 (the same on both meshes: their model axis is 16 in each):
# (arch, kind) -> (reference at 6e9, port at 30e9)
CHANGED_AT_30E9 = {
    ("dbrx-132b", "train"): ("fsdp", "zero1"),
    ("dbrx-132b", "prefill"): ("fsdp", "none"),
    ("dbrx-132b", "decode"): ("fsdp", "none"),
    ("granite-34b", "train"): ("zero1", "none"),
    ("pixtral-12b", "train"): ("zero1", "none"),
}


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _flat_j(tree, leaf_fn, is_leaf=None) -> dict:
    return {jax.tree_util.keystr(p): leaf_fn(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _flat_t(tree, leaf_fn, path="") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{path}['{k}']"
        if isinstance(v, dict):
            out.update(_flat_t(v, leaf_fn, p))
        else:
            out[p] = leaf_fn(v)
    return out


def _spec(s) -> tuple:
    return tuple(_entry(e) for e in s)


def _is_pspec(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


def _cfgs(arch, size):
    get = "get_config" if size == "full" else "get_smoke"
    return getattr(jreg, get)(arch), getattr(treg, get)(arch)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_pspecs_equal_the_reference(arch, shape, size,
                                                    monkeypatch):
    """Every leaf's shape and dtype, and every leaf's spec on both meshes
    with the port's budget at the reference's 6e9: its own decision, and
    on the 512-chip mesh ZeRO-1 forced (the moments' own specs)."""
    jc, tc = _cfgs(arch, size)
    js, ts = jreg.get_shape(shape), treg.get_shape(shape)
    want = _flat_j(JS.input_specs(jc, js),
                   lambda x: (tuple(x.shape), np.dtype(x.dtype).name))
    got = _flat_t(TS.input_specs(tc, ts),
                  lambda t: (tuple(t.shape), str(t.dtype).removeprefix(
                      "torch.")))
    assert got == want and len(got) > 3
    assert all(t.device.type == "meta" for t in
               jax.tree_util.tree_leaves(TS.input_specs(tc, ts)))
    monkeypatch.setattr(TS, "HBM_BUDGET_PER_DEV", 6e9)
    for mesh, fsdp in ((MESHES["pod"], None), (MESHES["multipod"], None),
                       (MESHES["multipod"], "zero1")):
        want = _flat_j(JS.input_pspecs(jc, js, mesh, fsdp=fsdp), _spec,
                       is_leaf=_is_pspec)
        got = _flat_t(TS.input_pspecs(tc, ts, mesh, fsdp=fsdp), _spec)
        assert got == want, (mesh.shape, fsdp)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_needs_fsdp_equals_the_reference_at_its_budget(arch, size,
                                                        monkeypatch):
    jc, tc = _cfgs(arch, size)
    monkeypatch.setattr(TS, "HBM_BUDGET_PER_DEV", 6e9)
    for kind in KINDS:
        for mesh in MESHES.values():
            assert TS.needs_fsdp(tc, kind, mesh) == \
                JS.needs_fsdp(jc, kind, mesh)


def test_the_port_budget_changes_only_the_stated_decisions():
    """At 30e9 (37.5 % of the card's 80 GB, the share of a v5e's 16 GB
    that the reference's 6e9 is), the listed full-size decisions move to
    less sharding and no other does."""
    assert TS.HBM_BUDGET_PER_DEV == 30e9
    assert JS.HBM_BUDGET_PER_DEV == 6e9
    for mesh in MESHES.values():
        changed = {}
        for arch in ARCHS:
            jc, tc = _cfgs(arch, "full")
            for kind in KINDS:
                ref, port = JS.needs_fsdp(jc, kind, mesh), \
                    TS.needs_fsdp(tc, kind, mesh)
                if ref != port:
                    changed[(arch, kind)] = (ref, port)
        assert changed == CHANGED_AT_30E9


def test_production_meshes_are_the_references_shapes():
    """(16, 16) over ("data", "model") and (2, 16, 16) over ("pod",
    "data", "model"): the reference's ``make_production_mesh`` axes and
    sizes, with no device behind them."""
    pod = tmesh.make_production_mesh()
    assert pod.axis_names == ("data", "model") and pod.size == 256
    assert pod.shape == MESHES["pod"].shape
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    assert mp.shape == MESHES["multipod"].shape
    m = tmesh.make_mesh_compat((4, 2), ("data", "stage"))
    assert m.shape == {"data": 4, "stage": 2} and m.size == 8
    assert not hasattr(m, "devices")
    with pytest.raises(ValueError, match="do not name"):
        tmesh.make_mesh_compat((4,), ("data", "model"))
    with pytest.raises(dataclasses.FrozenInstanceError):
        pod.sizes = (1, 1)


def test_to_shardings_binds_every_spec_to_the_mesh():
    mesh = tmesh.make_production_mesh(multi_pod=True)
    cfg = treg.get_smoke("phi3-mini-3.8b")
    pspecs = TS.input_pspecs(cfg, treg.get_shape("train_4k"), mesh)
    shard = TS.to_shardings(pspecs, mesh)
    flat_p = _flat_t(pspecs, lambda s: s)
    flat_s = _flat_t(shard, lambda s: s)
    assert flat_p.keys() == flat_s.keys()
    for k, s in flat_s.items():
        assert isinstance(s, TSH.NamedSharding)
        assert s.mesh is mesh and s.spec == flat_p[k]
    assert flat_s["['batch']['tokens']"].spec == TSH.P(("pod", "data"),
                                                       None)


@functools.cache
def _param_bytes(arch, dtype):
    tc = treg.get_config(arch)
    return sum(t.numel() * t.element_size() for t in
               jax.tree_util.tree_leaves(TS.abstract_params(tc, dtype)))


def test_a_dtype_sets_parameters_and_activations():
    """``input_specs(..., dtype)`` is the port's own: float32 parameters
    (the trainer's) double the bf16 bytes but for the leaves kept in
    float32, and the batch's embeddings follow it."""
    cfg = treg.get_config("pixtral-12b")
    shape = treg.get_shape("prefill_32k")
    f32 = TS.input_specs(cfg, shape, torch.float32)
    bf16 = TS.input_specs(cfg, shape)
    assert f32["batch"]["prefix_embeds"].dtype == torch.float32
    assert bf16["batch"]["prefix_embeds"].dtype == torch.bfloat16
    assert f32["batch"]["tokens"].dtype == torch.int32
    n32 = _param_bytes("pixtral-12b", torch.float32)
    n16 = _param_bytes("pixtral-12b", torch.bfloat16)
    assert n32 == 4 * cfg.param_count()
    assert 2 * cfg.param_count() <= n16 < n32
