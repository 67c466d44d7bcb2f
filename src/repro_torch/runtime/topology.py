"""Declarative serving topology: stages x replicas x transports.

DEFER's original runtime hard-wired one shape — a linear chain with exactly
one compute node per partition.  The follow-on work (SEIFER, arXiv
2210.12218/12219) gets its throughput from *replicating* bottleneck
partitions across a cluster, so the serving API is now topology-first: a
:class:`TopologySpec` lists the stages, and each :class:`StageSpec` binds a
contiguous layer range to a replica count, a routing policy, a transport,
and optional per-stage batching-knob overrides.  The dispatcher builds
whatever the spec says; nothing about "a chain of N nodes" is implicit
anymore.

    spec = TopologySpec.chain(graph, 4, strategy="balanced_latency")
    spec = spec.with_replicas(2, 3)          # stage 2 gets 3 replicas
    engine = InferenceEngine(graph, spec, codecs)

``TopologySpec.chain`` delegates cut selection to the partitioner (any
strategy, or explicit ``cuts``); hand-built specs pass explicit layer
ranges.  Replica counts are a *starting* point — ``Engine.scale(stage, n)``
grows or drains a live stage behind the epoch fence.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Sequence

from repro_torch.runtime.transport import get_transport

if TYPE_CHECKING:
    from repro_torch.core.graph import LayerGraph
    from repro_torch.core.partitioner import LinkModel


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: a layer range served by ``replicas`` identical
    compute nodes behind a router.

    ``routing`` spreads work across the replicas: ``"lqd"``
    (least-queue-depth, the default — adapts to replica jitter) or
    ``"rr"`` (strict round-robin).  ``transport`` names a registered
    :class:`~repro_torch.runtime.transport.Transport` backing this stage's
    channels — ``"inproc"`` (default), ``"tcp"`` (real loopback sockets),
    an emulated link like ``"link:10mbit,20ms"`` (the paper's CORE
    conditions), or any backend registered with ``register_transport``;
    stages may each bind a different one.  ``max_batch`` / ``coalesce_s``
    / ``shape_buckets`` / ``max_batch_cap`` override the engine-wide
    defaults for this stage only (None = inherit).

    ``session_capacity`` bounds each replica's resident decode-session KV
    caches (LRU eviction past it — an evicted session re-prefills, so this
    is a memory ceiling, not a correctness knob; None = runtime default).
    """

    layers: tuple[int, int]                 # [lo, hi) over graph.nodes
    replicas: int = 1
    transport: str = "inproc"
    routing: str = "lqd"
    max_batch: int | None = None
    coalesce_s: float | None = None
    shape_buckets: str | None = None
    max_batch_cap: int | None = None
    session_capacity: int | None = None


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The whole serving topology: an ordered tuple of stages whose layer
    ranges tile the graph."""

    stages: tuple[StageSpec, ...]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def bounds(self) -> list[int]:
        return [self.stages[0].layers[0]] + [s.layers[1] for s in self.stages]

    @property
    def cuts(self) -> tuple[int, ...]:
        return tuple(s.layers[1] for s in self.stages[:-1])

    @property
    def replicas(self) -> tuple[int, ...]:
        return tuple(s.replicas for s in self.stages)

    def validate(self, graph: "LayerGraph") -> None:
        if not self.stages:
            raise ValueError("a topology needs at least one stage")
        n = len(graph.nodes)
        if self.stages[0].layers[0] != 0 or self.stages[-1].layers[1] != n:
            raise ValueError(
                f"stages must cover layers [0, {n}); got "
                f"{[s.layers for s in self.stages]}")
        for a, b in zip(self.stages, self.stages[1:]):
            if a.layers[1] != b.layers[0]:
                raise ValueError(
                    f"stage ranges must be contiguous: {a.layers} then "
                    f"{b.layers}")
        for s in self.stages:
            lo, hi = s.layers
            if hi <= lo:
                raise ValueError(f"empty stage range {s.layers}")
            if s.replicas < 1:
                raise ValueError(f"stage {s.layers}: replicas must be >= 1")
            if s.routing not in ("rr", "lqd"):
                raise ValueError(f"unknown routing policy {s.routing!r}")
            get_transport(s.transport)      # raises on unknown binding

    def with_replicas(self, stage: int, replicas: int) -> "TopologySpec":
        """A copy with one stage's replica count changed."""
        stages = list(self.stages)
        stages[stage] = dataclasses.replace(stages[stage], replicas=replicas)
        return TopologySpec(tuple(stages))

    def with_layers(self, bounds: Sequence[int]) -> "TopologySpec":
        """A copy with every stage's layer range replaced (same stage
        count) — how a live repartition updates the spec."""
        if len(bounds) != len(self.stages) + 1:
            raise ValueError(f"{len(bounds)} bounds for "
                             f"{len(self.stages)} stages")
        stages = [dataclasses.replace(s, layers=(lo, hi))
                  for s, lo, hi in zip(self.stages, bounds, bounds[1:])]
        return TopologySpec(tuple(stages))

    @classmethod
    def chain(cls, graph: "LayerGraph", num_stages: int,
              strategy: str = "equal_layers",
              link: "LinkModel | None" = None,
              cuts: Sequence[int] | None = None,
              replicas: "int | Sequence[int] | None" = None,
              **stage_kw) -> "TopologySpec":
        """The classic DEFER shape: ``num_stages`` stages in series, layer
        ranges chosen by the partitioner (or pinned with ``cuts``).
        ``replicas`` seeds every stage (int) or each stage (sequence);
        extra keyword args apply to every stage (e.g. ``routing="rr"``)."""
        from repro_torch.core.partitioner import partition
        plan = partition(graph, num_stages, strategy=strategy, link=link,
                         cuts=cuts)
        if replicas is None:
            reps = [1] * num_stages
        elif isinstance(replicas, int):
            reps = [replicas] * num_stages
        else:
            reps = list(replicas)
            if len(reps) != num_stages:
                raise ValueError(f"{len(reps)} replica counts for "
                                 f"{num_stages} stages")
        return cls(tuple(StageSpec(layers=(lo, hi), replicas=r, **stage_kw)
                         for (lo, hi), r in zip(plan.ranges(), reps)))
