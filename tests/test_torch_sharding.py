"""The port's sharding rules (``sharding.py``) against the JAX package, on
every arch's full and smoke parameter trees as ``abstract_params`` gives
them (meta tensors on the port's side, ``jax.eval_shape`` on the
reference's) and on their decode caches.

The rules read only a mesh's ``shape`` and ``axis_names``, so both sides
get the same plain stand-in of the reference's 256- and 512-chip meshes;
no device is involved.  JAX's ``PartitionSpec`` writes a one-name tuple
entry as the name; the comparison reads both sides that way.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro import sharding as JS
from repro.configs import registry as jreg
from repro.models import transformer as JT
from repro_torch import sharding as TS
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = sorted(jreg.ARCHS)
MESHES = {
    "pod": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model")),
    "multipod": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
}


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def _flat_j(specs) -> dict:
    return {jax.tree_util.keystr(p): tuple(_entry(e) for e in s)
            for p, s in jax.tree_util.tree_flatten_with_path(specs)[0]}


def _flat_t(specs, path="") -> dict:
    out = {}
    for k, v in specs.items():
        p = f"{path}['{k}']"
        if isinstance(v, dict):
            out.update(_flat_t(v, p))
        else:
            assert isinstance(v, TS.P), p
            out[p] = tuple(_entry(e) for e in v)
    return out


@functools.cache
def _trees(arch, size):
    get = "get_config" if size == "full" else "get_smoke"
    return (JT.abstract_params(getattr(jreg, get)(arch)),
            TT.abstract_params(getattr(treg, get)(arch)))


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_pspecs_equal_the_reference(arch, size):
    """Model axis 16, with and without FSDP over the data axes (one axis
    of 16; pod x data of 2 x 16), and the Adam state's specs."""
    jp, tp = _trees(arch, size)
    want = _flat_j(JS.param_pspecs(jp, model_size=16))
    got = _flat_t(TS.param_pspecs(tp, model_size=16))
    assert got == want and len(got) > 0
    for axes, sizes in ((("data",), (16,)), (("pod", "data"), (2, 16))):
        assert _flat_t(TS.param_pspecs(tp, fsdp_axes=axes,
                                       fsdp_sizes=sizes)) == \
            _flat_j(JS.param_pspecs(jp, fsdp_axes=axes, fsdp_sizes=sizes))
    assert _flat_t(TS.opt_state_pspecs(tp)) == \
        _flat_j(JS.opt_state_pspecs(jp))


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_equal_the_reference(arch, size):
    """Decode caches at batch 1 (the long-context case: the sequence over
    data and model), 3 (no batch split) and 32, on both meshes."""
    get = "get_config" if size == "full" else "get_smoke"
    jc, tc = getattr(jreg, get)(arch), getattr(treg, get)(arch)
    for batch, max_len in ((1, 8192), (3, 4096), (32, 2048)):
        jcache = jax.eval_shape(lambda: JT.init_caches(jc, batch, max_len))
        tcache = TT.init_caches(tc, batch, max_len, device="meta")
        for mesh in MESHES.values():
            assert _flat_t(TS.cache_pspecs(tcache, mesh)) == \
                _flat_j(JS.cache_pspecs(jcache, mesh)), (batch, mesh.shape)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_equal_the_reference(mesh):
    m = MESHES[mesh]
    for B in (1, 2, 3, 16, 24, 32, 64, 96):
        assert TS.input_batch_axes(B, m) == JS.input_batch_axes(B, m), B
    assert tuple(_entry(e) for e in TS.batch_pspec(m)) == \
        tuple(_entry(e) for e in JS.batch_pspec(m))
    batch = {"tokens": np.zeros((32, 16), np.int32),
             "embeds": np.zeros((32, 8, 4), np.float32)}
    assert _flat_t(TS.batch_pspecs(batch, m)) == \
        _flat_j(JS.batch_pspecs(batch, m))


def test_axis_size_reads_the_mesh():
    assert TS.axis_size(MESHES["multipod"], "pod") == 2
    assert TS.P("data", None) == ("data", None)
    assert repr(TS.P("data", None)) == "P('data', None)"
