"""The port's dry run (``launch/dryrun.py``): every step traced on the
``meta`` device, its argument bytes against the JAX package's
``jax.eval_shape`` trees and specs, its FLOP count's linearity in depth
(the reference's extrapolation claim), and the reference's
``reduced_depth`` / ``_extrapolate`` twins.

The reference's dry run compiles for 512 fake XLA devices; importing its
module sets that flag.  ``_ref_dryrun`` imports it after this process's
JAX backend exists and puts the environment back, so nothing here or in
later tests of the same process sees 512 devices.
"""
import dataclasses
import json
import os
import resource
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import specs as JS
from repro_torch.configs import registry as treg
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as TS

torch.set_num_threads(1)

_ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = sorted(jreg.ARCHS)
PAIRS = jreg.all_pairs()
MESHES = {
    "pod": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model")),
    "multipod": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
}
ONE_CARD = tmesh.make_mesh_compat((1, 1), ("data", "model"))


def _ref_dryrun():
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jd


# -- every pair traces ---------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", PAIRS)
def test_every_smoke_pair_traces_on_meta(arch, shape):
    """The smoke config at the pair's full input shape on the 256-chip
    mesh (the per-device batch slice): status "ok", only meta tensors,
    the exact per-device argument bytes, some temp bytes and FLOPs; a
    pair the registry rules out is skipped for the reference's reason.
    An SSM smoke config keeps its full config's SSD chunk (256): the
    plain scan traces op by op per chunk, and the smoke chunk of 32 makes
    1024 chunks of a 32k sequence (55 s for zamba2's prefill here)."""
    ok, reason = jreg.pair_supported(arch, shape)
    assert treg.pair_supported(arch, shape) == (ok, reason)
    if not ok:
        art = TD.dryrun_pair(arch, shape, verbose=False)
        assert art["status"] == "skip" and art["reason"] == reason
        return
    cfg, s = treg.get_smoke(arch), treg.get_shape(shape)
    if cfg.ssm:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk=treg.get_config(arch).ssm.chunk))
    mesh = tmesh.make_production_mesh()
    art = TD.dryrun_step(cfg, s, mesh)
    assert art["status"] == "ok" and art["devices"] == ["meta"]
    assert sum(art["off_meta"].values()) == 0
    assert art["chips"] == 256 and art["kind"] == s.kind
    assert art["local_batch"] == s.global_batch // (
        16 if s.global_batch % 16 == 0 else 1)
    mem = art["memory"]
    assert mem["argument_bytes"] == TD.sharded_bytes(
        TS.input_specs(cfg, s), TS.input_pspecs(cfg, s, mesh), mesh)
    assert mem["temp_bytes"] > 0 and art["cost"]["flops"] > 0
    assert art["cost"]["collective_bytes"] is None
    if s.kind == "train":      # params and moments updated in place
        assert mem["alias_bytes"] > 0
    if s.kind != "decode":
        assert 0.5 < art["cost"]["flops"] / art["cost"]["flops_estimate"] < 3


# -- argument bytes against the reference --------------------------------------------

def _shards(spec, mesh) -> int:
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= mesh.shape[a]
    return n


def _ref_argument_bytes(cfg, shape, mesh, fsdp) -> int:
    specs = jax.tree_util.tree_leaves(
        JS.input_pspecs(cfg, shape, mesh, fsdp=fsdp),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves = jax.tree_util.tree_leaves(JS.input_specs(cfg, shape))
    assert len(specs) == len(leaves)
    total = 0
    for leaf, spec in zip(leaves, specs):
        nbytes = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        assert nbytes % _shards(spec, mesh) == 0
        total += nbytes // _shards(spec, mesh)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_references_eval_shape_over_its_shards(arch):
    """Every full-size pair on both meshes, at the reference's own FSDP
    decision: the port's per-device argument bytes are the sum of the
    reference's ``jax.eval_shape`` leaf bytes over their shard counts."""
    jc, tc = jreg.get_config(arch), treg.get_config(arch)
    for shape in sorted(jreg.INPUT_SHAPES):
        js, ts = jreg.get_shape(shape), treg.get_shape(shape)
        for mesh in MESHES.values():
            fsdp = JS.needs_fsdp(jc, js.kind, mesh)
            got = TD.sharded_bytes(TS.input_specs(tc, ts),
                                   TS.input_pspecs(tc, ts, mesh, fsdp=fsdp),
                                   mesh)
            assert got == _ref_argument_bytes(jc, js, mesh, fsdp), \
                (shape, mesh.shape)


# -- FLOPs: linear in depth -----------------------------------------------------------

def _flops(cfg, shape) -> float:
    art = TD.dryrun_step(cfg, shape, ONE_CARD, torch.float32)
    return art["cost"]["flops"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_depth_flops_equal_the_extrapolation_of_2_and_4_units(arch,
                                                                   kind):
    """The trace counts every unit, so 6 units' FLOPs equal the
    reference's linear extrapolation from 2 and 4 units within 1e-9
    relative (smoke widths, 2 x 32 tokens or a 32-slot cache)."""
    cfg = TD.reduced_depth(treg.get_smoke(arch), 6)
    shape = InputShape("t", 32, 2, kind)
    f = {k: _flops(TD.reduced_depth(cfg, k), shape) for k in (2, 4, 6)}
    assert f[2] < f[4] < f[6]
    ext = TD._extrapolate({"flops": f[2]}, {"flops": f[4]}, 6)
    assert ext["collective_bytes"] is None
    assert abs(ext["flops"] - f[6]) <= 1e-9 * f[6]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_depth_equals_the_references(arch):
    jd = _ref_dryrun()
    for get in ("get_config", "get_smoke"):
        jc, tc = getattr(jreg, get)(arch), getattr(treg, get)(arch)
        for k in (1, 2, 4):
            assert dataclasses.asdict(TD.reduced_depth(tc, k)) == \
                dataclasses.asdict(jd.reduced_depth(jc, k))


def test_extrapolate_equals_the_references():
    """The reference test's synthetic costs and seeded ones, at depths
    below, at and past the 4 units extrapolated from."""
    jd = _ref_dryrun()
    rng = np.random.default_rng(0)

    def mk(u, a):
        return {"flops": a[0] + a[1] * u, "bytes_accessed": a[2] + a[3] * u,
                "transcendentals": a[4] * u,
                "collective_bytes": {"all-reduce": int(a[5]) * u,
                                     "all-gather": int(a[6]) * u}}

    for a in [np.array([10, 3, 5, 2, 1, 100, 7])] + \
            [rng.uniform(0, 1e6, 7) for _ in range(5)]:
        for n in (2, 4, 6, 32, 40):
            assert TD._extrapolate(mk(2, a), mk(4, a), n) == \
                jd._extrapolate(mk(2, a), mk(4, a), n)


# -- the trace holds nothing ------------------------------------------------------------

def test_live_bytes_counts_new_storages_once_and_releases_them():
    x = torch.empty(1000, device="meta")
    with TD.LiveBytes([x.untyped_storage()]) as m:
        y = x * 2                       # 4000 new bytes
        v = y.view(10, 100)             # a view: nothing new
        y.add_(1)                       # in place: nothing new
        assert m.now == 4000
        z = x.reshape(10, 100)          # a view of an input: nothing
        del y
        assert m.now == 4000            # v keeps the storage alive
        del v
        assert m.now == 0
        w = (x + 1).sum()               # a temporary freed at once
        assert m.now == 4 and m.peak == 4004
        e = torch.empty(0)              # a zero-size CPU placeholder
    assert m.devices == {"meta"} and z.shape == (10, 100) and w.dim() == 0
    assert m.off_meta == {"aten.empty.memory_format@cpu": 0} and \
        e.numel() == 0


def test_a_full_size_dry_run_allocates_no_real_storage():
    """starcoder2-3b's prefill_32k holds ~20 GB of temporaries as traced;
    the process's peak resident memory grows by far less, and every op's
    output was a meta tensor."""
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    art = TD.dryrun_pair("starcoder2-3b", "prefill_32k", verbose=False)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - before
    assert art["status"] == "ok" and art["devices"] == ["meta"]
    assert art["memory"]["temp_bytes"] > 10e9
    assert grown < 1e9
    assert art["cost"]["flops"] > 1e9


def test_the_cli_writes_one_artifact_per_pair_and_mesh(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "mamba2-2.7b", "--shape", "decode_32k", "--both-meshes",
           "--out", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, env=env, cwd=_ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "all dry-runs OK" in r.stdout
    names = sorted(os.listdir(tmp_path))
    assert names == ["mamba2-2.7b__decode_32k__pod1.json",
                     "mamba2-2.7b__decode_32k__pod2.json"]
    arts = [json.loads((tmp_path / n).read_text()) for n in names]
    assert [a["chips"] for a in arts] == [256, 512]
    assert all(a["status"] == "ok" and a["memory"]["argument_bytes"] > 0
               for a in arts)
