"""Dry run: trace every (arch x shape x mesh) step on PyTorch's ``meta``
device (the twin of ``repro.launch.dryrun``).

The reference lowers and compiles each pair's step with ``jax.jit`` for
the 16x16 single-pod mesh and the 2x16x16 multi-pod mesh over 512 fake
host devices, and keeps XLA's memory and cost analyses.  The port has no
compiler to ask, so it runs the step itself, at full size, on tensors of
the ``meta`` device: every op computes its output's shape and dtype and
nothing is allocated or computed.  A step that traces is a step whose
shapes are coherent at that size.

* Inputs are :mod:`repro_torch.launch.specs`' meta trees.  The trace
  runs the per-device batch slice (the global batch over the data axes
  that ``sharding.input_batch_axes`` splits it by) on the plain path
  (``use_kernel`` False, as the reference's steps).
* ``memory.argument_bytes`` is exact and per device: every input leaf's
  bytes over its shard count under ``specs.input_pspecs``.
* ``memory.temp_bytes`` is the peak of the intermediate storages live at
  once during the trace (:class:`LiveBytes`): each op's output storage
  counted once when it appears and released when it dies; views and
  in-place ops add nothing.  The port has no tensor-parallel program, so
  this is a program with the model axis whole on one device at the
  per-device batch slice, not the reference's per-device figure on a
  model axis of 16.  On the one-card mesh (data 1, model 1) argument +
  temp bytes is the step's predicted peak.
* ``memory.output_bytes`` / ``alias_bytes``: the step's outputs as traced,
  and of them those that are input storages updated in place.
* ``cost.flops``: :class:`torch.utils.flop_counter.FlopCounterMode` over
  the whole trace (matmuls and attention; activation checkpointing's
  recomputed forward included).  A Python-loop trace counts every unit,
  so the full depth needs no extrapolation; :func:`reduced_depth` and
  :func:`_extrapolate` are kept as the reference's, and a test holds the
  two ways equal.
* ``collective_bytes`` is null: the reference parses it from XLA's
  partitioned HLO, and the port runs no SPMD program that has one.

Usage:
    python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
        [--out artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as sh
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.registry import (ARCHS, all_pairs, get_config,
                                          get_shape, pair_supported)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import step_for
from repro_torch.models import transformer as T

TEMP_SCOPE = ("the traced program: the model axis whole on one device at "
              "the per-device batch slice (the port has no tensor-parallel "
              "program)")


def _storages(tree: Any):
    for t in _pytree_leaves(tree):
        if isinstance(t, torch.Tensor):
            yield t.untyped_storage()


class LiveBytes(TorchDispatchMode):
    """Peak bytes of the storages that ops create while the mode is on.

    A storage is keyed by ``untyped_storage()._cdata`` (on ``meta`` every
    ``data_ptr()`` is 0), counted once when an op first returns it and
    released by ``weakref.finalize`` when it dies.  Storages in ``known``
    (the step's inputs) are never counted, nor are views of them; a view
    or an in-place op returns a storage already seen.  ``devices`` is the
    set of device types of the storages with bytes that the ops returned;
    ``off_meta`` names every op that returned a storage on another device,
    with its bytes (torch 2.11's activation checkpointing makes a
    zero-size CPU placeholder per unit: 0 bytes, nothing computed)."""

    def __init__(self, known=()):
        super().__init__()
        self.known = {st._cdata for st in known}
        self.live: dict[int, int] = {}
        self.now = self.peak = 0
        self.devices: set[str] = set()
        self.off_meta: dict[str, int] = {}

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for st in _storages(out):
            if st.nbytes():
                self.devices.add(st.device.type)
            if st.device.type != "meta":
                name = f"{func}@{st.device.type}"
                self.off_meta[name] = self.off_meta.get(name, 0) + st.nbytes()
            key = st._cdata
            if key in self.live or key in self.known:
                continue
            self.live[key] = st.nbytes()
            self.now += self.live[key]
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.now)
        return out


def _shards(spec: sh.P, mesh) -> int:
    n = 1
    for e in spec:
        for a in ((e,) if isinstance(e, str) else (e or ())):
            n *= int(mesh.shape[a])
    return n


def sharded_bytes(args: Any, pspecs: Any, mesh) -> int:
    """Per-device bytes of a tree of tensors under its tree of specs."""
    if isinstance(args, dict):
        return sum(sharded_bytes(args[k], pspecs[k], mesh) for k in args)
    n = _shards(pspecs, mesh)
    total = args.numel() * args.element_size()
    if total % n:
        raise ValueError(f"{tuple(args.shape)} does not split over {n} "
                         f"shards of {pspecs}")
    return total // n


def _distinct_bytes(storages) -> int:
    return sum({st._cdata: st.nbytes() for st in storages}.values())


def _local_shape(shape: InputShape, mesh) -> InputShape:
    """The per-device slice of ``shape``: its batch over the data axes
    that ``sharding.input_batch_axes`` splits it by."""
    axes = sh.input_batch_axes(shape.global_batch, mesh)
    n = math.prod(int(mesh.shape[a]) for a in axes)
    return dataclasses.replace(shape, global_batch=shape.global_batch // n)


def dryrun_step(cfg: ModelConfig, shape: InputShape, mesh,
                dtype: torch.dtype = S.PARAM_DTYPE,
                with_cost: bool = True) -> dict:
    """Trace ``steps.step_for(cfg, shape.kind)`` on ``meta`` at the
    per-device slice of ``shape`` on ``mesh`` (anything with ``shape`` and
    ``axis_names``) with parameters and activations in ``dtype``; returns
    the artifact (the module docstring says what each figure is).
    ``fsdp`` is ``specs.needs_fsdp``'s decision, priced at bf16 weights
    whatever ``dtype`` is; the argument bytes are ``dtype``'s."""
    fsdp = S.needs_fsdp(cfg, shape.kind, mesh)
    pspecs = S.input_pspecs(cfg, shape, mesh, fsdp=fsdp)
    arg_bytes = sharded_bytes(S.input_specs(cfg, shape, dtype), pspecs, mesh)
    local = _local_shape(shape, mesh)
    args = S.input_specs(cfg, local, dtype)
    step = step_for(cfg, shape.kind)
    live = LiveBytes(_storages(args))
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops if with_cost else contextlib.nullcontext(), live:
        out = step(*args.values())
    trace_s = time.perf_counter() - t0
    outs = list(_storages(out))
    art = {
        "status": "ok", "chips": math.prod(mesh.shape.values()),
        "kind": shape.kind, "fsdp": fsdp,
        "dtype": str(dtype).removeprefix("torch."),
        "local_batch": local.global_batch, "seq_len": shape.seq_len,
        "compile_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _distinct_bytes(outs),
            "alias_bytes": _distinct_bytes(
                st for st in outs if st._cdata in live.known),
            "temp_bytes": live.peak,
            "temp_scope": TEMP_SCOPE},
        "devices": sorted(live.devices), "off_meta": live.off_meta,
    }
    if with_cost:
        art["cost"] = {"flops": float(flops.get_total_flops()),
                       "collective_bytes": None}
        if shape.kind != "decode":
            art["cost"]["flops_estimate"] = T.flops_estimate(
                cfg, local.global_batch, shape.seq_len, shape.kind)
    return art


def reduced_depth(cfg: ModelConfig, k: int) -> ModelConfig:
    """Same config with k repeating units (remainder layers kept)."""
    u = cfg.unit_layers
    rem = cfg.num_layers % u
    upd = {"num_layers": u * k + rem}
    if cfg.encoder_layers:
        upd["encoder_layers"] = k
    return dataclasses.replace(cfg, **upd)


_COST_KEYS = ("flops", "bytes_accessed", "transcendentals")


def _extrapolate(c2: dict, c4: dict, n_units: int) -> dict:
    """Linear-in-units extrapolation of cost terms from 2 and 4 units:
    cost(L) = cost(4u) + (n_units - 4)/2 * (cost(4u) - cost(2u)).  Terms
    absent or null in ``c4`` (the port counts no bytes accessed,
    transcendentals or collective bytes) stay so."""
    scale = (n_units - 4) / 2.0

    def ext(a, b):
        return max(0.0, b + scale * (b - a))

    out = {k: ext(c2[k], c4[k]) for k in _COST_KEYS if c4.get(k) is not None}
    coll = c4.get("collective_bytes")
    out["collective_bytes"] = None if coll is None else {
        k: int(ext(c2["collective_bytes"][k], coll[k])) for k in coll}
    return out


def dryrun_pair(arch: str, shape_name: str, multi_pod: bool = False,
                verbose: bool = True, with_cost: bool = True,
                cfg_overrides: dict | None = None) -> dict:
    """Trace one (arch, shape, production mesh) pair's step at full size
    in bf16; returns its artifact.  ``cfg_overrides``:
    ``dataclasses.replace`` overrides of the config."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    ok, reason = pair_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skip", "reason": reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    art = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
           **dryrun_step(cfg, get_shape(shape_name), mesh,
                         with_cost=with_cost)}
    if verbose:
        mb = art["memory"]
        msg = (f"{arch:26s} {shape_name:12s} pods={2 if multi_pod else 1} "
               f"trace={art['compile_s']:.1f}s "
               f"arg={mb['argument_bytes'] / 1e9:.2f}GB "
               f"temp={mb['temp_bytes'] / 1e9:.2f}GB fsdp={art['fsdp']}")
        if "cost" in art:
            cost = art["cost"]
            msg += f" flops={cost['flops']:.3g}"
            if "flops_estimate" in cost:
                msg += f" ({cost['flops'] / cost['flops_estimate']:.3f}x est)"
        print(msg, flush=True)
    return art


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    pairs = all_pairs() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in pairs:
        for mp in meshes:
            try:
                art = dryrun_pair(arch, shape, multi_pod=mp)
            except Exception as e:  # a failure here is a bug in the port
                art = {"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                failures.append(art)
                print(f"FAIL {arch} {shape} multi_pod={mp}: {e}", flush=True)
            fn = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(art, f, indent=1)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures")
    print("all dry-runs OK")


if __name__ == "__main__":
    main()
