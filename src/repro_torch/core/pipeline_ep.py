"""Pipeline + expert parallelism (PP x EP) — the twin of
``repro.core.pipeline_ep``.

Big-MoE serving (llama4-maverick 400B, dbrx 132B) cannot keep a stage's
full expert set on one device.  The reference's layout is the DEFER chain
*per group of chips*, ``mesh = (data, expert, stage)``:

* stage  — the paper's compute-node chain (relays, microbatches):
           :mod:`repro_torch.core.pipeline`
* expert — within a stage: attention is head-sharded (each shard's
           ``wo`` partial summed over the shards) and the MoE is GShard
           expert parallelism (:func:`repro_torch.models.moe.moe_block_local`)
* data   — replicated chains, each over its slice of every microbatch's
           rows (:class:`repro_torch.core.pipeline.Pipeline`)

The reference runs this as one SPMD program under ``shard_map``.  The port
drives a stage's ``ax`` expert shards itself, in shard order: the
reference's ``psum`` is a sum of the shards' partials in shard order, its
token all-gather a concatenation, its ``all_to_all``s the exchange inside
``moe_block_local``.  Each shard's weights are views of the stage's (cut
by :func:`_ep_weight_specs` along a non-leading dim), so the device does
not hold the weights twice.  On one card every shard of a stage is on that
stage's device (:class:`repro_torch.launch.mesh.StageMesh`).

The stage's input is the whole ``[mb, S, d]`` microbatch (replicated over
the expert axis in the reference), and its output is too: one relay per
hop, through the block-quant codec when ``compress`` is set.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import tree_map, tree_map_with_path
from repro_torch.core.pipeline import PipelineConfig, make_pipeline
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as T
from repro_torch.models.attention import AttnSpec, _chunked_attention
from repro_torch.sharding import P, axis_size


def ep_unit_fn(cfg: ModelConfig, unroll: bool = False):
    """Stage body over a stage's expert shards: ``stage_fn((shards,
    valid), x)`` with ``shards`` a list of ``ax`` unit trees [u, ...] (one
    per shard, cut by :func:`shard_units`) and ``valid`` [u].  Padded units
    are identity.  ``unroll`` changes nothing (the port loops)."""
    del unroll
    spec = T.moe_spec(cfg)
    hd = cfg.head_dim
    scale = 1.0 / np.sqrt(hd)

    def apply_layer(lps: list, x: torch.Tensor) -> torch.Tensor:
        ax = len(lps)
        mb, S, d = x.shape
        pos = T._positions(mb, S, x.device)
        # -- attention, heads sharded over the expert axis ----------------
        h = L.rmsnorm(lps[0]["attn"]["ln"], x, cfg.norm_eps)
        Hl = cfg.num_heads // ax
        kvl = max(1, cfg.kv_heads // ax)
        s_local = AttnSpec(d, Hl, kvl, hd)             # local-head view
        C = min(s_local.q_chunk, S)
        if S % C:
            C = S
        partial = []
        for lp in lps:
            a = lp["attn"]
            q = (h @ a["wq"]["w"]).reshape(mb, S, Hl, hd)
            k = (h @ a["wk"]["w"]).reshape(mb, S, kvl, hd)
            v = (h @ a["wv"]["w"]).reshape(mb, S, kvl, hd)
            q = L.apply_rope(q, pos, cfg.rope_theta)
            k = L.apply_rope(k, pos, cfg.rope_theta)
            qs = q.reshape(mb, S // C, C, Hl, hd)
            o = _chunked_attention(qs, k, v, pos.reshape(mb, S // C, C), pos,
                                   s_local, scale, C)
            partial.append(o.reshape(mb, S, Hl * hd) @ a["wo"]["w"])
        x = x + functools.reduce(torch.add, partial)   # psum, shard order
        # -- MoE, tokens split over the expert axis ------------------------
        T_tot = mb * S
        if T_tot % ax:
            raise ValueError(f"{T_tot} tokens of a microbatch do not split "
                             f"over {ax} expert shards")
        T_l = T_tot // ax
        x_flat = x.reshape(T_tot, d)
        ys, _ = moe_mod.moe_block_local(
            [lp["moe"] for lp in lps], spec,
            [x_flat[i * T_l:(i + 1) * T_l][None] for i in range(ax)],
            cfg.norm_eps)
        return torch.cat([y[0] for y in ys]).reshape(mb, S, d)  # all-gather

    def stage_fn(local, x):
        shards, valid = local
        for j, ok in enumerate(valid):
            if ok:
                x = apply_layer([tree_map(lambda a: a[j], sh["pos0"])
                                 for sh in shards], x)
        return x

    return stage_fn


def _ep_spec(path: tuple, leaf, stage_axis: str, expert_axis: str) -> P:
    keys = [str(k) for k in path]
    name = keys[-1]
    nd = len(leaf.shape)
    if "moe" in keys and name in ("up", "gate", "down"):
        return P(stage_axis, None, expert_axis, *([None] * (nd - 3)))
    if name == "w" and "wo" in keys:
        return P(stage_axis, None, expert_axis, None)
    if name == "w" and any(k in keys for k in ("wq", "wk", "wv")):
        return P(stage_axis, None, None, expert_axis)
    return P(stage_axis, *([None] * (nd - 1)))


def _ep_weight_specs(units: Any, stage_axis: str, expert_axis: str):
    """Per-leaf specs: [S, u, ...] with head/expert dims over the EP axis."""
    return tree_map_with_path(
        lambda path, leaf: _ep_spec(path, leaf, stage_axis, expert_axis),
        units)


def shard_units(units: Any, ax: int, stage_axis: str = "stage",
                expert_axis: str = "expert") -> list:
    """The ``ax`` expert shards of a stage-stacked unit tree: each leaf cut
    along the dim :func:`_ep_weight_specs` gives ``expert_axis`` (views,
    no copy)."""
    def cut(i):
        def one(path, a):
            spec = _ep_spec(path, a, stage_axis, expert_axis)
            if expert_axis not in spec:
                return a
            dim = spec.index(expert_axis)
            n = a.shape[dim]
            if n % ax:
                raise ValueError(f"{'/'.join(map(str, path))}: dim {dim} "
                                 f"of {n} does not split over {ax} shards")
            return a.narrow(dim, i * (n // ax), n // ax)
        return tree_map_with_path(one, units)

    return [cut(i) for i in range(ax)]


class EPPipeline:
    """The expert-parallel chain as a callable, ``fn((units, valid), x_mb)
    -> y_mb``; ``relayed`` is its last call's relay log."""

    def __init__(self, pipe, ax: int, stage_axis: str, expert_axis: str):
        self.pipe, self.ax = pipe, ax
        self.axes = (stage_axis, expert_axis)

    @property
    def relayed(self):
        return self.pipe.relayed

    def __call__(self, w, x_mb):
        units, valid = w
        return self.pipe((shard_units(units, self.ax, *self.axes), valid),
                         x_mb)


def build_ep_pipeline(cfg: ModelConfig, mesh, num_stages: int,
                      num_microbatches: int, compress: bool = False,
                      unroll: bool = False,
                      data_axes: tuple[str, ...] = ("data",),
                      expert_axis: str = "expert",
                      stage_axis: str = "stage",
                      quant_impl: str = "kernel"):
    """Returns ``fn_factory(units_stacked, valid) -> fn`` for MoE decoder
    archs, where ``fn((units_stacked, valid), x_mb [M, mb, S, d]) -> y_mb``
    and ``units_stacked, valid = stack_stages(params["units"], ...)``.

    ``mesh`` is a :class:`repro_torch.launch.mesh.StageMesh` (or anything
    with ``shape``, ``num_stages`` and ``devices``); its ``expert_axis``
    size is the shard count, and its ``data_axes`` sizes multiply to the
    number of chains, each over its slice of every microbatch's rows, so
    each shard of a chain dispatches ``mb * S / (D * ax)`` tokens at their
    own capacity.  ``quant_impl`` is the relay codec's route, as in
    :class:`repro_torch.core.pipeline.PipelineConfig`.
    """
    pipe_cfg = PipelineConfig(num_stages=num_stages,
                              num_microbatches=num_microbatches,
                              axis=stage_axis, compress=compress,
                              quant_impl=quant_impl, unroll_ticks=unroll)
    ax = axis_size(mesh, expert_axis)
    pipe = make_pipeline(mesh, pipe_cfg, ep_unit_fn(cfg, unroll=unroll),
                         data_axes=data_axes)

    def fn_factory(units_stacked, valid):
        del units_stacked, valid        # cut per call, as shard_map's specs
        return EPPipeline(pipe, ax, stage_axis, expert_axis)

    return fn_factory
