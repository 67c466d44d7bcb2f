"""Meta-tensor stand-ins and shardings for every (arch x shape) pair (the
twin of ``repro.launch.specs``).

``input_specs`` returns the inputs of the step the shape's *kind* runs
(train_step / prefill_step / serve_step) as tensors on PyTorch's ``meta``
device: shapes and dtypes, no storage.  The modality frontends are stubs,
as in the reference: VLM / audio entries get precomputed patch / frame
embeddings of the right shape.

``input_pspecs`` gives their partition specs over a mesh (anything with
``shape`` and ``axis_names``: :func:`repro_torch.launch.mesh.
make_production_mesh`'s shape-only meshes, as the dry run uses them), by
the port's :mod:`repro_torch.sharding` rules, which are the reference's.
``to_shardings`` binds them to the mesh; it places nothing.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import sharding as sh
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.graph import tree_map
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import init_opt_state

PARAM_DTYPE = torch.bfloat16
ACT_DTYPE = torch.bfloat16
META = torch.device("meta")


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = PARAM_DTYPE):
    return T.abstract_params(cfg, dtype)


def abstract_opt_state(cfg: ModelConfig, dtype: torch.dtype = PARAM_DTYPE):
    """Adam's float32 moments and step count as meta tensors."""
    return init_opt_state(abstract_params(cfg, dtype))


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype = ACT_DTYPE):
    return T.init_caches(cfg, batch, max_len, dtype, device=META)


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, B: int, S: int, kind: str,
                dtype: torch.dtype = ACT_DTYPE) -> dict:
    """The data-batch part of the step inputs."""
    out: dict[str, Any] = {"tokens": _sds((B, S), torch.int32)}
    if kind == "train":
        out["labels"] = _sds((B, S), torch.int32)
    if cfg.num_prefix_embeds and not cfg.encoder_layers:
        out["prefix_embeds"] = _sds((B, cfg.num_prefix_embeds, cfg.d_model),
                                    dtype)
    if cfg.encoder_layers:
        out["encoder_embeds"] = _sds((B, cfg.num_prefix_embeds, cfg.d_model),
                                     dtype)
    return out


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype: torch.dtype | None = None) -> dict:
    """Meta-tensor args for the step this shape runs.

    train   -> {params, opt_state, batch}
    prefill -> {params, batch}
    decode  -> {params, token, pos, caches}

    ``dtype`` None gives the reference's (bf16 parameters and
    activations); a dtype sets both (the port's trainer runs float32).
    """
    pdt, adt = (PARAM_DTYPE, ACT_DTYPE) if dtype is None else (dtype, dtype)
    B, S = shape.global_batch, shape.seq_len
    params = abstract_params(cfg, pdt)
    if shape.kind == "train":
        return {"params": params,
                "opt_state": init_opt_state(params),
                "batch": batch_specs(cfg, B, S, "train", adt)}
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batch_specs(cfg, B, S, "prefill", adt)}
    return {"params": params,
            "token": _sds((B, 1), torch.int32),
            "pos": _sds((B,), torch.int32),
            "caches": abstract_caches(cfg, B, S, adt)}


# The reference's budget is 6e9 B, headroom below a v5e's 16 GB for
# activations (37.5 % of the chip).  The port's card is an 80 GB H100;
# the same share of it is 30e9 B.
HBM_BUDGET_PER_DEV = 30e9


def needs_fsdp(cfg: ModelConfig, kind: str, mesh) -> str:
    """Weight / optimizer distribution mode for this (model, step, mesh),
    by the reference's rule against :data:`HBM_BUDGET_PER_DEV` bytes a
    device.  It prices bf16 weights and f32 moments whatever dtype a
    step runs in.

    "none"  — tensor sharding alone fits.
    "zero1" — weights fit tensor-sharded but the Adam state doesn't: shard
              only the moments over the data axes.
    "fsdp"  — even the bf16 weights exceed the budget: shard weights and
              moments over the data axes.
    """
    bytes_per_param = 10 if kind == "train" else 2   # bf16 + 2x f32 moments
    model = mesh.shape["model"]
    if cfg.param_count() * bytes_per_param / model <= HBM_BUDGET_PER_DEV:
        return "none"
    if cfg.param_count() * 2 / model <= HBM_BUDGET_PER_DEV:
        return "zero1" if kind == "train" else "none"
    return "fsdp"


def input_pspecs(cfg: ModelConfig, shape: InputShape, mesh,
                 fsdp: str | None = None) -> dict:
    """Partition specs matching ``input_specs`` (baseline data x tensor;
    ZeRO-1 / FSDP where ``needs_fsdp`` says so, or as ``fsdp`` says)."""
    B = shape.global_batch
    b_axes = sh.input_batch_axes(B, mesh)
    bspec = sh.P(b_axes) if b_axes else sh.P()

    def batch_tree(tree):
        return tree_map(lambda leaf: sh.P(b_axes, *([None] * (leaf.dim() - 1)))
                        if b_axes else sh.P(), tree)

    data_axes = tuple(a for a in mesh.axis_names if a != "model")
    data_sizes = tuple(mesh.shape[a] for a in data_axes)
    if fsdp is None:
        fsdp = needs_fsdp(cfg, shape.kind, mesh)
    ab = abstract_params(cfg)
    params = sh.param_pspecs(
        ab, model_size=mesh.shape["model"],
        fsdp_axes=data_axes if fsdp == "fsdp" else None,
        fsdp_sizes=data_sizes if fsdp == "fsdp" else ())
    if shape.kind == "train":
        moments = params if fsdp != "zero1" else sh.param_pspecs(
            ab, model_size=mesh.shape["model"],
            fsdp_axes=data_axes, fsdp_sizes=data_sizes)
        return {"params": params,
                "opt_state": {"mu": moments, "nu": moments, "step": sh.P()},
                "batch": batch_tree(batch_specs(cfg, B, shape.seq_len,
                                                "train"))}
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batch_tree(batch_specs(cfg, B, shape.seq_len,
                                                "prefill"))}
    return {"params": params, "token": bspec, "pos": bspec,
            "caches": sh.cache_pspecs(abstract_caches(cfg, B, shape.seq_len),
                                      mesh)}


def to_shardings(pspecs: Any, mesh) -> Any:
    """Each spec bound to ``mesh`` as a
    :class:`repro_torch.sharding.NamedSharding`; nothing is placed."""
    return sh.bind(mesh, pspecs)
