"""Stage-to-device maps and mesh shapes (the twin of
``repro.launch.mesh``).

The reference lays DEFER's chain on the "stage" axis of a JAX mesh and runs
it as one SPMD program, replicated over its data axes (the paper's
"independent chains").  The port has no SPMD mesh: its pipeline is one
process that drives every stage and every chain itself
(:mod:`repro_torch.core.pipeline`), so a :class:`StageMesh` is only which
device each stage runs on, and how many chains and expert shards it has.

The trainer's mesh is the reference's data x model mesh over the
devices there are (``make_host_mesh(model)`` there): here
:class:`DeviceMesh` over the one card, built by
:func:`make_data_model_mesh`, whose axes are both of size 1 (an axis of
size > 1 raises: a mesh of several cards is left over in ROADMAP
queue 1).

:func:`make_mesh_compat` and :func:`make_production_mesh` give the
reference's mesh shapes as an :class:`AbstractMesh`: axis names and sizes,
no devices.  Nothing runs on one; the dry run (``launch/dryrun.py``) and
the sharding rules read only its shape.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.device import get_device


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape without devices (``jax.sharding.AbstractMesh``):
    ``axis_names`` in order, ``shape`` axis name -> size, ``size`` their
    product."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.sizes} do not name the axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_mesh_compat(shape: tuple[int, ...], axes: tuple[str, ...]
                     ) -> AbstractMesh:
    """The reference's ``jax.make_mesh(shape, axes)`` as a shape only."""
    return AbstractMesh(tuple(axes), tuple(int(n) for n in shape))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production meshes: (16, 16) over ("data",
    "model"), 256 chips; (2, 16, 16) over ("pod", "data", "model"), 512
    chips, "pod" being pure data parallelism across pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes)


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """One device per pipeline stage, in chain order.  Each stage may be
    cut into ``expert_shards`` expert-parallel shards
    (:mod:`repro_torch.core.pipeline_ep`), all on the stage's device, and
    the chain replicated ``data`` times (the reference's data axis): the
    port runs the ``data`` chains one after another on the same stage
    devices."""
    devices: tuple[torch.device, ...]
    axis: str = "stage"
    expert_shards: int = 1
    data: int = 1

    @property
    def num_stages(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return {"data": self.data, "expert": self.expert_shards,
                self.axis: self.num_stages}


def make_pipeline_mesh(num_stages: int,
                       devices: Sequence[str | torch.device] | None = None,
                       expert_shards: int = 1, data: int = 1) -> StageMesh:
    """DEFER's chain of ``num_stages`` stages, each of ``expert_shards``
    expert shards, ``data`` chains of it.  With no ``devices``, every
    stage is on :func:`repro_torch.device.get_device`'s device (the one
    card, or the CPU where the caller set it); given several, stages go
    round robin over them."""
    if num_stages < 1 or expert_shards < 1 or data < 1:
        raise ValueError(f"num_stages {num_stages}, expert_shards "
                         f"{expert_shards} and data {data} must be >= 1")
    devs = ([get_device()] if devices is None
            else [get_device(d) for d in devices])
    if not devs:
        raise ValueError("devices is empty")
    return StageMesh(tuple(devs[s % len(devs)] for s in range(num_stages)),
                     expert_shards=expert_shards, data=data)


def make_host_mesh(num_stages: int = 1,
                   device: str | torch.device | None = None,
                   expert_shards: int = 1, data: int = 1) -> StageMesh:
    """Every stage on one device: ``device``, or
    :func:`repro_torch.device.get_device`'s (CPU tests and smoke runs)."""
    return make_pipeline_mesh(num_stages, [get_device(device)],
                              expert_shards, data)


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A named-axis mesh of devices, as a JAX mesh: ``shape`` maps axis
    name -> size and ``axis_names`` orders them.  The port holds one
    device, so every axis is of size 1."""
    device: torch.device
    axis_names: tuple[str, ...] = ("data", "model")
    sizes: tuple[int, ...] = (1, 1)

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"sizes {self.sizes} do not name the axes "
                             f"{self.axis_names}")
        if any(n != 1 for n in self.sizes):
            raise NotImplementedError(
                f"mesh {dict(zip(self.axis_names, self.sizes))}: an axis "
                "of size > 1 needs several cards (ROADMAP queue 1, left "
                "over: a mesh of several cards); the port's mesh is one "
                "device")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_data_model_mesh(model: int | None = None,
                         device: str | torch.device | None = None
                         ) -> DeviceMesh:
    """The trainer's ("data", "model") mesh over the one device (the
    reference's ``make_host_mesh(model)``): ``device``, or
    :func:`repro_torch.device.get_device`'s.  ``model`` > 1 raises."""
    return DeviceMesh(get_device(device), sizes=(1, model or 1))
