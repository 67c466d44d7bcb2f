"""DEFER's compute-node chain as a stage pipeline (the twin of
``repro.core.pipeline``).

The paper's architecture — a dispatcher feeding a chain of compute nodes
that each run a contiguous model partition and relay activations
FIFO-style — is, in the reference, one SPMD program over a "stage" mesh
axis.  The port runs the same schedule from one process:

* compute node  ->  a stage: a contiguous run of units on its device
  (:class:`repro_torch.launch.mesh.StageMesh`)
* TCP relay     ->  the stage's output handed to the next stage
  (``.to(next_device, non_blocking=True)``; no copy when both stages are
  on the one card), where the reference's ``ppermute`` shifts it
* FIFO stream   ->  the reference's GPipe ticks, run in order on the host
* ZFP wire codec -> optional int8 block quantization of every relayed
  leaf: the int8 payload and its f32 scales cross, and the next stage
  dequantizes.  The round trip runs even when both stages share the card:
  the lossy relay is part of the result, not only of its transport.

Schedule (the reference's): ``M + S - 1`` ticks; at tick t stage s serves
microbatch t - s; stage 0 takes microbatch t from the stream; the last
stage's output at tick t is microbatch t - (S - 1) of the result.

Bubble ticks.  The reference computes them on garbage and masks them out,
because one SPMD program runs every stage at every tick.  The port skips a
stage's tick when t - s is outside [0, M), and the relay of that tick with
it; the last stage's output is collected, not relayed (the reference's
wrap-around hop to stage 0 carries nothing stage 0 reads).  So a call
relays ``M * (S - 1)`` times per leaf of the stream, and with
``compress=True`` and ``quant_impl="kernel"`` on a card it launches each
block-quant kernel that many times: 24 for one activation at M 8, S 4.

``quant_impl``: ``"kernel"`` runs :mod:`repro_torch.kernels.block_quant`'s
wrappers on the padded grid — the CUDA kernel for a CUDA tensor, its plain
version for a CPU tensor (the reference's ``"pallas"``); ``"plain"`` always
runs :mod:`repro_torch.kernels.ref`'s ``quantize_blocks_ref`` /
``dequantize_blocks_ref`` (the reference's ``"jnp"``).  The port's default
is ``"kernel"``, so nothing on the card runs the plain version unless
asked to; the reference's default is ``"jnp"``.

The stage body is caller-supplied (``unit_fn``), so the same pipeline
drives every family: dense and SSM units relay ``[mb, seq, d]``; an
encoder-decoder relays ``{"h", "enc"}`` leaf by leaf; zamba2's shared
block rides as ``extra``, passed whole to every stage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.graph import tree_leaves, tree_map
from repro_torch.kernels import block_quant as bq
from repro_torch.kernels import ref as kref

QUANT_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_stages: int
    num_microbatches: int
    axis: str = "stage"            # the stage axis' name (StageMesh.axis)
    compress: bool = False         # int8 block-quant every relayed leaf
    quant_impl: str = "kernel"     # "kernel" (ref "pallas") | "plain" ("jnp")
    # the reference's dry-run cost accounting (an unrolled scan); the port
    # runs its ticks eagerly, so this changes nothing
    unroll_ticks: bool = False

    def __post_init__(self):
        if self.quant_impl not in QUANT_IMPLS:
            raise ValueError(f"quant_impl {self.quant_impl!r}: want one of "
                             f"{QUANT_IMPLS}")
        if self.num_stages < 1 or self.num_microbatches < 1:
            raise ValueError("num_stages and num_microbatches must be >= 1")


@dataclasses.dataclass
class RelayLog:
    """What one pipeline call relayed from stage to stage."""
    relays: int = 0        # leaves handed to another stage
    encoded: int = 0       # of them through the block-quant codec
    raw_bytes: int = 0     # their bytes as the stage produced them
    wire_bytes: int = 0    # the bytes that crossed (q and scales if encoded)


# -- wire codec (the ZFP adaptation applied to the relay) -----------------------

def _wire_encode(y: torch.Tensor, impl: str):
    """y [mb, seq, d] -> (q int8, scales f32) of its [mb*seq, d] rows
    zero-padded to whole (8, 128) tiles."""
    mb, s, d = y.shape
    flat = y.reshape(mb * s, d)
    R, C = flat.shape
    padr, padc = (-R) % kref.TILE_R, (-C) % kref.TILE_C
    if padr or padc:
        flat = F.pad(flat, (0, padc, 0, padr))
    if impl == "kernel":
        return bq.quantize_blocks(flat.to(torch.float32).contiguous())
    return kref.quantize_blocks_ref(flat)


def _wire_decode(q: torch.Tensor, sc: torch.Tensor, shape, dtype,
                 impl: str) -> torch.Tensor:
    mb, s, d = shape
    flat = (bq.dequantize_blocks(q, sc) if impl == "kernel"
            else kref.dequantize_blocks_ref(q, sc))
    return flat[: mb * s, :d].reshape(mb, s, d).to(dtype)


def relay(y: Any, device: torch.device, cfg: PipelineConfig,
          log: RelayLog) -> Any:
    """Hand a stage's output pytree to the stage on ``device``.  With
    ``cfg.compress`` each float leaf of rank >= 2 crosses as q and scales
    and is dequantized there; integer leaves and leaves of rank < 2 (the
    decode relay's tokens) cross raw, as in the reference."""
    def one(a: torch.Tensor) -> torch.Tensor:
        log.relays += 1
        log.raw_bytes += a.nbytes
        if not cfg.compress or not a.is_floating_point() or a.dim() < 2:
            log.wire_bytes += a.nbytes
            return a.to(device, non_blocking=True)
        q, sc = _wire_encode(a, cfg.quant_impl)
        log.encoded += 1
        log.wire_bytes += q.nbytes + sc.nbytes
        return _wire_decode(q.to(device, non_blocking=True),
                            sc.to(device, non_blocking=True), a.shape,
                            a.dtype, cfg.quant_impl)

    return tree_map(one, y)


# -- the chain -------------------------------------------------------------------

def stage_slice(tree: Any, s: int, device: torch.device) -> Any:
    """Stage ``s``'s part of a stage-stacked tree, on ``device``: views of
    the stack where it is already there (no copy on one card).  A numpy
    leaf (the validity mask) stays on the host, where the stage body reads
    it."""
    def one(a):
        if isinstance(a, np.ndarray):
            return a[s]
        return a[s].to(device, non_blocking=True)

    return tree_map(one, tree)


def _stack(trees: list) -> Any:
    """Leaf-wise stack of same-structure trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _devices(devices: Sequence[torch.device] | None, like: torch.Tensor,
             S: int) -> tuple[torch.device, ...]:
    devs = (like.device,) * S if devices is None else tuple(devices)
    if len(devs) != S:
        raise ValueError(f"{len(devs)} devices for {S} stages")
    return devs


def pipeline_apply(stage_params: Any, x_mb: Any, extra: Any = None, *,
                   unit_fn: Callable[..., Any], cfg: PipelineConfig,
                   devices: Sequence[torch.device] | None = None,
                   log: RelayLog | None = None) -> Any:
    """Run the whole chain (every stage, every tick) in this process.

    stage_params: pytree with leading dim ``num_stages`` (stage s's slice is
    ``a[s]``; see :func:`stack_stages`).
    x_mb: microbatch-stream pytree, every leaf [M, ...].  A plain tensor is
    the common single-activation case; enc-dec chains relay
    {"h": ..., "enc": ...} so the encoder output rides the wire.
    extra: pytree every stage needs whole (zamba2's shared block); passed
    as ``unit_fn(local, x, extra)``.
    devices: stage s runs on ``devices[s]`` (default: the stream's device).
    Returns the same pytree with leaves [M, ...], the last stage's outputs
    in FIFO order.
    """
    S, M = cfg.num_stages, cfg.num_microbatches
    leaves = tree_leaves(x_mb)
    if any(a.shape[0] != M for a in leaves):
        raise ValueError(f"every stream leaf must lead with M={M}: "
                         f"{[tuple(a.shape) for a in leaves]}")
    devs = _devices(devices, leaves[0], S)
    log = RelayLog() if log is None else log
    local = [stage_slice(stage_params, s, devs[s]) for s in range(S)]
    extras = [None if extra is None else
              tree_map(lambda a, d=devs[s]: a.to(d, non_blocking=True), extra)
              for s in range(S)]
    inbox: list = [None] * S
    out: list = [None] * M
    for t in range(M + S - 1):
        nxt: list = [None] * S
        for s in range(max(0, t - M + 1), min(S, t + 1)):  # 0 <= t - s < M
            k = t - s
            x_in = (tree_map(lambda a: a[k].to(devs[0], non_blocking=True),
                             x_mb) if s == 0 else inbox[s])
            y = (unit_fn(local[s], x_in) if extra is None
                 else unit_fn(local[s], x_in, extras[s]))
            if s == S - 1:
                out[k] = y
            else:
                nxt[s + 1] = relay(y, devs[s + 1], cfg, log)
        inbox = nxt
    return _stack(out)


class Pipeline:
    """The chain as a callable, ``fn(stage_params, x_mb[, extra]) -> y_mb``
    (see :func:`pipeline_apply`); ``relayed`` is its last call's
    :class:`RelayLog`."""

    def __init__(self, mesh, cfg: PipelineConfig,
                 unit_fn: Callable[..., Any], with_extra: bool):
        self.mesh, self.cfg, self.unit_fn = mesh, cfg, unit_fn
        self.with_extra = with_extra
        self.relayed = RelayLog()

    def __call__(self, stage_params: Any, x_mb: Any, extra: Any = None):
        if self.with_extra != (extra is not None):
            raise TypeError("extra is required exactly when the pipeline "
                            "was built with_extra")
        self.relayed = RelayLog()
        return pipeline_apply(stage_params, x_mb, extra, unit_fn=self.unit_fn,
                              cfg=self.cfg, devices=self.mesh.devices,
                              log=self.relayed)


def make_pipeline(mesh, cfg: PipelineConfig, unit_fn: Callable[..., Any],
                  data_axes: tuple[str, ...] = (),
                  with_extra: bool = False) -> Pipeline:
    """Build the pipeline callable over ``mesh`` (a
    :class:`repro_torch.launch.mesh.StageMesh`, one device per stage).

    Returns ``fn(stage_params, x_mb) -> y_mb`` (``fn(stage_params, x_mb,
    extra)`` when ``with_extra``), where ``stage_params`` has leading dim
    ``num_stages``, ``x_mb [M, mb, seq, d]`` is the microbatch stream and
    ``y_mb [M, mb, seq, d]`` the outputs in FIFO order.

    ``data_axes`` replicates the chain over groups of devices in the
    reference (the paper's "independent chains"); the port has one chain,
    so it must be empty (ROADMAP queue 1 item 11).
    """
    if data_axes:
        raise NotImplementedError(
            f"data_axes {data_axes}: replicated chains over several device "
            "groups are not ported yet (ROADMAP queue 1 item 11)")
    if mesh.num_stages != cfg.num_stages:
        raise ValueError(f"mesh has {mesh.num_stages} stages, the config "
                         f"{cfg.num_stages}")
    return Pipeline(mesh, cfg, unit_fn, with_extra)


# -- stage-stacking helpers ---------------------------------------------------------

def stack_stages(unit_params: Any, n_units: int, num_stages: int):
    """[n_units, ...] unit stack -> ([S, u_per_stage, ...], valid [S, u]).

    DEFER pads the chain when layers don't divide evenly; padded unit slots
    carry zero params and a False validity mask, and the stage body skips
    them (the reference turns them into identity relays), preserving exact
    model semantics for any (L, S).  Where S divides ``n_units`` the
    stacked leaves are views of ``unit_params`` (the card does not hold the
    weights twice); padding copies.  ``valid`` is a numpy bool array: the
    stage body reads it on the host.
    """
    u = -(-n_units // num_stages)              # ceil
    pad = u * num_stages - n_units

    def pad_stack(a: torch.Tensor) -> torch.Tensor:
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        return a.reshape((num_stages, u) + tuple(a.shape[1:]))

    stacked = tree_map(pad_stack, unit_params)
    valid = (np.arange(num_stages * u) < n_units).reshape(num_stages, u)
    return stacked, valid


def make_stage_unit_fn(apply_unit: Callable[[Any, Any], Any]):
    """Wrap a single-unit apply into a multi-unit stage body.

    ``apply_unit(unit_params, x) -> y``; the stage runs its local units in
    order and skips the padded ones (identity).
    """
    def stage_fn(stage_local, x):
        units, valid = stage_local             # units: [u, ...], valid: [u]
        for j, ok in enumerate(valid):
            if ok:
                x = apply_unit(tree_map(lambda a: a[j], units), x)
        return x

    return stage_fn
