"""Logical-axis sharding rules (maxtext-style) for every model family (the
twin of ``repro.sharding``).

The reference's baseline distribution is 2D/3D data x tensor parallelism:

* batch            -> ("pod", "data")     (pod axis only on the 512-chip mesh)
* attention heads / MLP hidden / experts / vocab -> "model"
* everything small (norms, routers, scalars)     -> replicated

Rules are *path-based*: the leaf's key names decide its spec, with any
leading stacked-unit dims left unsharded, so one rule table covers dense,
MoE, SSM, hybrid and enc-dec params alike.

A spec is a :class:`P`, a tuple with one entry per leading dim (an axis
name, a tuple of names, or None).  A mesh is anything with ``shape`` (axis
name -> size) and ``axis_names``.  The leaves may be tensors of any device
(``transformer.abstract_params``' meta tensors included): only their
shapes are read.  ``param_shardings`` and ``batch_shardings`` bind the
specs to a :class:`repro_torch.launch.mesh.DeviceMesh` as
:class:`NamedSharding` objects, and :func:`device_put` places a tree by them:
on the one card every spec places the whole leaf on the mesh's device.
The stage pipeline shards its expert axis with
:func:`repro_torch.core.pipeline_ep._ep_weight_specs`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.graph import tree_map, tree_map_with_path


class P(tuple):
    """A partition spec: ``P("data", None, "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_size(mesh, name: str) -> int:
    """Size of a named mesh axis (the reference reads it inside
    ``shard_map``; the port's shards are driven from one process)."""
    return int(mesh.shape[name])


# leaf name -> (which matrix dim gets "model")
_SHARD_LAST = {"wq", "wk", "wv", "up", "gate", "in_proj"}   # d_in x d_out: out
_SHARD_FIRST = {"wo", "down", "out_proj"}                   # d_in x d_out: in
_REPLICATE = {"scale", "bias", "b", "router", "conv_w", "conv_b",
              "A_log", "D", "dt_bias"}


def _leaf_spec(path: tuple, leaf, model_axis: str, model_size: int) -> P:
    keys = [str(k) for k in path]
    name = keys[-1]
    parents = set(keys[:-1])
    ndim = len(leaf.shape)

    def first_fitting(*candidates: tuple) -> P:
        """First candidate tail whose sharded dims divide evenly."""
        for tail in candidates:
            lead = ndim - len(tail)
            dims = leaf.shape[lead:]
            if all(ax is None or d % model_size == 0
                   for ax, d in zip(tail, dims)):
                return P(*([None] * lead + list(tail)))
        return P()

    if name == "table":                      # embedding [V, d]
        return first_fitting((model_axis, None), (None, model_axis))
    if name == "w" and "unembed" in parents:
        return first_fitting((None, model_axis), (model_axis, None))
    if "moe" in parents and name in ("up", "gate", "down"):
        # experts [.., E, d, f] -> expert-sharded; fall back to hidden dim
        return first_fitting((model_axis, None, None),
                             (None, None, model_axis))
    if name in _REPLICATE or ndim <= 1:
        return P()
    if name in _SHARD_LAST:
        return first_fitting((None, model_axis), (model_axis, None))
    if name in _SHARD_FIRST:
        return first_fitting((model_axis, None), (None, model_axis))
    if name == "w":                           # generic linear
        return first_fitting((None, model_axis), (model_axis, None))
    return P()


def _add_fsdp(leaf, spec: P, fsdp_axes: tuple[str, ...], fsdp_n: int) -> P:
    """Also shard the largest still-unsharded dim that ``fsdp_n`` divides
    over the data axes."""
    if len(leaf.shape) < 2:
        return spec
    entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
    cands = [(d, i) for i, (d, ax) in enumerate(zip(leaf.shape, entries))
             if ax is None and d % fsdp_n == 0 and d >= fsdp_n]
    if not cands:
        return spec
    _, i = max(cands)
    entries[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def param_pspecs(params: Any, model_axis: str = "model",
                 model_size: int = 16,
                 fsdp_axes: tuple[str, ...] | None = None,
                 fsdp_sizes: tuple[int, ...] = ()) -> Any:
    """Tree of :class:`P` matching ``params``.

    ``model_size`` is the tensor axis length; dims that don't divide fall
    back to the other matrix dim (mamba2's 50280 vocab, seamless' 256206)
    or to replication.  ``fsdp_axes`` additionally shards the largest
    still-unsharded dim of every matrix over the data axes (ZeRO-3 / FSDP
    style), which dbrx-132b and llama4-400b need to fit with their Adam
    state.
    """
    fsdp_n = int(np.prod(fsdp_sizes))

    def spec(path, leaf):
        s = _leaf_spec(path, leaf, model_axis, model_size)
        return _add_fsdp(leaf, s, fsdp_axes, fsdp_n) if fsdp_axes else s

    return tree_map_with_path(spec, params)


def batch_pspec(mesh) -> P:
    """Batch sharded over every non-model axis present in the mesh."""
    return P(tuple(a for a in mesh.axis_names if a != "model"))


def batch_pspecs(batch: Any, mesh) -> Any:
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return tree_map(lambda leaf: P(axes, *([None] * (len(leaf.shape) - 1))),
                    batch)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P


def _bind(mesh, specs: Any) -> Any:
    if isinstance(specs, dict):
        return {k: _bind(mesh, v) for k, v in specs.items()}
    return NamedSharding(mesh, specs)


def param_shardings(params: Any, mesh, model_axis: str = "model") -> Any:
    specs = param_pspecs(params, model_axis,
                         model_size=mesh.shape[model_axis])
    return _bind(mesh, specs)


def batch_shardings(batch: Any, mesh) -> Any:
    return _bind(mesh, batch_pspecs(batch, mesh))


def device_put(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` (tensor or numpy array) on its sharding's
    mesh device: the whole leaf, as a mesh whose axes are all of size 1
    lays it (a leaf already there is returned as it is)."""
    if isinstance(shardings, NamedSharding):
        if any(n != 1 for n in shardings.mesh.shape.values()):
            raise NotImplementedError(
                f"device_put over mesh {shardings.mesh.shape}: the port "
                "places leaves on one device (ROADMAP queue 1, left over: "
                "a mesh of several cards)")
        return torch.as_tensor(tree).to(shardings.mesh.device)
    return {k: device_put(tree[k], v) for k, v in shardings.items()}


def opt_state_pspecs(params: Any, model_axis: str = "model") -> Any:
    """Adam moments shard exactly like their parameters."""
    p = param_pspecs(params, model_axis)
    return {"mu": p, "nu": p, "step": P()}


# -- decode caches ----------------------------------------------------------------

def _axes_size(mesh, axes: tuple[str, ...]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def _batch_or_none(B: int, mesh, data_axes: tuple[str, ...]):
    return data_axes if (B > 1 and B % _axes_size(mesh, data_axes) == 0) \
        else None


def cache_pspecs(caches: Any, mesh, model_axis: str = "model") -> Any:
    """Sharding for KV / SSM decode caches.

    Batch shards over the data axes when divisible; the cache *sequence*
    dim shards over "model" (or over data+model when batch is unsharded,
    the long_500k B=1 case), which keeps a 524k-token cache inside one
    device's memory.  Head/state dims shard over "model" where the
    sequence dim doesn't.
    """
    data_axes = tuple(a for a in mesh.axis_names if a != model_axis)

    def spec(path, leaf):
        name = str(path[-1])
        nd = len(leaf.shape)

        def tail(tail_spec: tuple) -> P:
            return P(*([None] * (nd - len(tail_spec)) + list(tail_spec)))

        if name in ("k", "v", "kpos", "kscale", "vscale"):
            b_dim = nd - (4 if name in ("k", "v") else
                          3 if name in ("kscale", "vscale") else 2)
            B, C = leaf.shape[b_dim], leaf.shape[b_dim + 1]
            if B > 1 and B % _axes_size(mesh, data_axes) == 0:
                b_ax, seq_ax = data_axes, (model_axis,)
            else:
                b_ax, seq_ax = None, data_axes + (model_axis,)
            if C % _axes_size(mesh, seq_ax) != 0:
                seq_ax = ((model_axis,) if C % mesh.shape[model_axis] == 0
                          else None)
            rest = ((None, None) if name in ("k", "v")
                    else (None,) if name in ("kscale", "vscale") else ())
            return tail((b_ax, seq_ax) + rest)
        if name == "conv":
            ch = leaf.shape[-1]
            m = model_axis if ch % mesh.shape[model_axis] == 0 else None
            return tail((_batch_or_none(leaf.shape[nd - 3], mesh, data_axes),
                         None, m))
        if name == "ssd":
            H = leaf.shape[-3]
            m = model_axis if H % mesh.shape[model_axis] == 0 else None
            return tail((_batch_or_none(leaf.shape[nd - 4], mesh, data_axes),
                         m, None, None))
        if name == "enc_out":
            return tail((_batch_or_none(leaf.shape[0], mesh, data_axes),
                         None, None))
        return P()

    return tree_map_with_path(spec, caches)


def input_batch_axes(B: int, mesh, model_axis: str = "model"):
    """Largest prefix of the data axes that divides the global batch."""
    axes = tuple(a for a in mesh.axis_names if a != model_axis)
    while axes and B % _axes_size(mesh, axes) != 0:
        axes = axes[1:]
    return axes
