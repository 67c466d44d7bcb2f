"""CORE-network-emulator analogue: analytic emulation of the DEFER chain
(the twin of ``repro.core.emulator``; host numpy only, like it).

The paper runs dispatcher + k compute nodes as separate network namespaces
under CORE with emulated Ethernet links, then measures steady-state inference
throughput, per-node energy, serialization overhead and network payload.

We reproduce that measurement harness analytically + with *measured* codec
timings: the layer graph gives exact per-stage FLOPs and exact inter-stage
activation shapes; the codecs are real (repro_torch.core.codecs), so
serialization overhead and wire payload are measured on real arrays of
exactly the tensor shapes that cross each cut.  Compute/transfer times come from the
:class:`HardwareProfile` / :class:`LinkModel` constants (the emulated part —
CORE emulates links the same way).

Steady-state FIFO pipeline throughput = 1 / max_i service_i, where
service_i = deserialize_i + compute_i + serialize_i + transfer_i
(each node is single-threaded per the paper's THREAD-1/THREAD-2 socket pair:
it relays sample t before computing sample t+1's result is available).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core import codecs
from repro_torch.core.graph import LayerGraph, tree_bytes
from repro_torch.core.metrics import (EDGE, HardwareProfile,
                                      compute_energy_j, idle_energy_j,
                                      network_energy_j)
from repro_torch.core.partitioner import LinkModel, partition

CHUNK_BYTES = 512 * 1024  # paper: 512 kB chunked transfer


@dataclasses.dataclass
class CodecConfig:
    serializer: codecs.SerName = "zfp"      # "json" | "zfp"
    compression: codecs.CompName = "none"   # "lz4"  | "none"
    zfp_rate: int = 16

    @property
    def label(self) -> str:
        comp = "LZ4" if self.compression == "lz4" else "Uncompressed"
        return f"{self.serializer.upper()}/{comp}"


@dataclasses.dataclass
class WireMeasurement:
    """Measured (not modeled) serialization cost for one tensor transfer."""

    raw_bytes: int
    wire_bytes: int
    encode_s: float
    decode_s: float
    chunks: int

    @property
    def overhead_s(self) -> float:
        return self.encode_s + self.decode_s


def measure_wire(shape: Sequence[int], cfg: CodecConfig, seed: int = 0,
                 sample_limit: int = 1 << 21, repeats: int = 3
                 ) -> WireMeasurement:
    """Encode/decode a real array of `shape`; subsample huge tensors.

    Pure-python LZ4 runs ~1-5 MB/s, so tensors beyond ``sample_limit`` bytes
    are measured on a slice and scaled linearly (ratio and per-byte timing
    are byte-local for both codecs).  Timings are
    min-of-``repeats`` (least OS/scheduler contention on a 1-core host).
    """
    n = int(np.prod(shape))
    nbytes = n * 4
    scale = 1.0
    if nbytes > sample_limit:
        scale = nbytes / sample_limit
        n = sample_limit // 4
    rng = np.random.default_rng(seed)
    # activation-like data: correlated + sparse-ish (post-ReLU), compressible
    arr = rng.normal(size=n).astype(np.float32)
    arr = np.maximum(arr + 0.3 * np.roll(arr, 1), 0.0)
    best_enc = best_dec = float("inf")
    stats = None
    for _ in range(max(1, repeats)):
        _, stats = codecs.roundtrip(arr, cfg.serializer, cfg.compression,
                                    cfg.zfp_rate)
        best_enc = min(best_enc, stats.encode_s)
        best_dec = min(best_dec, stats.decode_s)
    wire = stats.wire_bytes * scale
    return WireMeasurement(
        raw_bytes=int(nbytes),
        wire_bytes=int(wire),
        encode_s=best_enc * scale,
        decode_s=best_dec * scale,
        chunks=int(np.ceil(wire / CHUNK_BYTES)),
    )


@dataclasses.dataclass
class StageReport:
    node: int
    compute_s: float
    serialize_s: float
    deserialize_s: float
    transfer_s: float
    payload_bytes: int
    energy_j: float                  # active (work) energy, whole stage
    replicas: int = 1                # identical nodes serving this stage
    idle_energy_j: float = 0.0       # baseline burn of the stage's nodes
    #                                  while waiting on the bottleneck

    @property
    def service_s(self) -> float:
        """Per-request service latency (replication never shortens one
        request's own path)."""
        return self.compute_s + self.serialize_s + self.deserialize_s + self.transfer_s

    @property
    def rate_service_s(self) -> float:
        """The stage's contribution to the pipeline bottleneck: replicas
        split the request stream, so the *rate* amortizes by 1/replicas."""
        return self.service_s / max(1, self.replicas)


@dataclasses.dataclass
class EmulationReport:
    model: str
    num_nodes: int                   # total nodes incl. replicas
    codec: str
    throughput_cps: float            # inference cycles / second
    single_device_cps: float
    per_node_energy_j: float         # avg energy per node per inference cycle
    single_device_energy_j: float
    total_payload_mb: float          # per inference cycle
    overhead_s: float                # total serialization time per cycle
    stages: list[StageReport]
    replicas: tuple = ()             # per-stage replica counts ((), pre-
    #                                  replica shape, when not requested)

    @property
    def speedup(self) -> float:
        return self.throughput_cps / self.single_device_cps

    @property
    def energy_ratio(self) -> float:
        return self.per_node_energy_j / self.single_device_energy_j


@dataclasses.dataclass
class ConfigStepReport:
    """The configuration step: dispatcher ships architecture + weights."""

    kind: str                       # "architecture" | "weights" | "data"
    codec: str
    energy_j: float
    overhead_s: float
    payload_mb: float


def emulate(graph: LayerGraph, num_nodes: int,
            cfg: CodecConfig | None = None,
            hw: HardwareProfile = EDGE,
            link: LinkModel | None = None,
            strategy: str = "equal_layers",
            seed: int = 0,
            replicas: Sequence[int] | None = None) -> EmulationReport:
    """Emulate DEFER steady state for ``graph`` on ``num_nodes`` compute
    stages.

    ``replicas`` (per-stage counts, SEIFER-style replicated partitions)
    adds the replica dimension: the pipeline bottleneck amortizes each
    stage's service time by its replica count (rate, never a request's
    own latency), ``num_nodes`` becomes the total node count, and energy
    gains the idle term the paper's per-node measurement implies — every
    replica of a non-bottleneck stage sits idle part of each cycle, and a
    powered-on idle node still draws ``hw.idle_w``.  ``replicas=None``
    (default) reproduces the pre-replica report exactly.
    """
    cfg = cfg or CodecConfig()
    link = link or LinkModel(bandwidth_bytes_per_s=hw.link_bw,
                             energy_per_bit_j=hw.energy_per_bit_j)
    from repro_torch.core.partitioner import ComputeModel
    comp = ComputeModel(flops_per_s=hw.peak_flops, tdp_w=hw.tdp_w)
    reps = list(replicas) if replicas is not None else None
    if reps is not None and len(reps) != num_nodes:
        raise ValueError(f"{len(reps)} replica counts for "
                         f"{num_nodes} stages")
    part = partition(graph, num_nodes, strategy=strategy, link=link,
                     compute=comp, replicas=reps)

    stages: list[StageReport] = []
    outbound: list[WireMeasurement] = []
    for si, st in enumerate(part.stages):
        compute_s = st.flops / hw.peak_flops
        # measure real codec cost on the outbound activation of this stage
        out_elems = max(1, st.out_bytes // 4)
        wm = measure_wire((out_elems,), cfg, seed=seed + si)
        transfer_s = link.latency_s * wm.chunks + wm.wire_bytes / link.bandwidth_bytes_per_s
        # inbound deserialization (previous stage's payload)
        if si == 0:
            in_elems = max(1, tree_bytes(graph.input_spec) // 4)
            wm_in = measure_wire((in_elems,), cfg, seed=seed + 101 + si)
        else:
            wm_in = outbound[-1]
        energy = (
            compute_energy_j(compute_s + wm.encode_s + wm_in.decode_s, hw)
            + network_energy_j(wm.wire_bytes, hw)
        )
        stages.append(StageReport(
            node=si,
            compute_s=compute_s,
            serialize_s=wm.encode_s,
            deserialize_s=wm_in.decode_s,
            transfer_s=transfer_s,
            payload_bytes=wm.wire_bytes,
            energy_j=energy,
            replicas=reps[si] if reps is not None else 1,
        ))
        outbound.append(wm)

    # steady-state cycle time: the slowest stage RATE (service amortized
    # by replicas; with replicas=None this is exactly max service_s)
    bottleneck = max(s.rate_service_s for s in stages)
    throughput = 1.0 / bottleneck

    total_nodes = sum(reps) if reps is not None else num_nodes
    if reps is not None:
        # idle burn per cycle: each replica of stage i works
        # (compute+codec)/replicas seconds of a cycle and idles the rest —
        # the paper's per-node baseline that over-provisioning pays for
        for s in stages:
            active_per_replica = (s.compute_s + s.serialize_s
                                  + s.deserialize_s) / s.replicas
            s.idle_energy_j = s.replicas * idle_energy_j(
                bottleneck - active_per_replica, hw)

    # single-device baseline: whole graph on one node, no wire codecs
    single_compute_s = graph.total_flops / hw.peak_flops
    single_cps = 1.0 / single_compute_s
    single_energy = compute_energy_j(single_compute_s, hw)

    return EmulationReport(
        model=graph.name,
        num_nodes=total_nodes,
        codec=cfg.label,
        throughput_cps=throughput,
        single_device_cps=single_cps,
        per_node_energy_j=sum(s.energy_j + s.idle_energy_j
                              for s in stages) / total_nodes,
        single_device_energy_j=single_energy,
        total_payload_mb=sum(s.payload_bytes for s in stages) / 1e6,
        overhead_s=sum(s.serialize_s + s.deserialize_s for s in stages),
        stages=stages,
        replicas=tuple(reps) if reps is not None else (),
    )


def emulate_config_step(graph: LayerGraph, num_nodes: int, cfg: CodecConfig,
                        hw: HardwareProfile = EDGE, seed: int = 0
                        ) -> dict[str, ConfigStepReport]:
    """Configuration-step costs: architecture JSON + weights arrays (Table I)."""
    import json as _json

    # architecture spec: layer names/shapes/edges, like a Keras config JSON
    arch_spec = [
        {"name": n.name, "inputs": list(n.inputs),
         "out_shape": list(n.out_spec.shape), "flops": n.flops}
        for n in graph.nodes
    ]
    blob = _json.dumps(arch_spec).encode()
    t0 = time.perf_counter()
    if cfg.compression == "lz4":
        wire = codecs.Lz4Codec().compress(blob)
    else:
        wire = blob
    t1 = time.perf_counter()
    arch = ConfigStepReport(
        kind="architecture", codec=cfg.label,
        energy_j=compute_energy_j(t1 - t0, hw) + network_energy_j(len(wire), hw),
        overhead_s=t1 - t0,
        payload_mb=len(wire) / 1e6,
    )

    # weights: measured on real arrays, scaled to total param bytes
    pbytes = graph.total_param_bytes
    wm = measure_wire((max(1, pbytes // 4),), cfg, seed=seed)
    weights = ConfigStepReport(
        kind="weights", codec=cfg.label,
        energy_j=compute_energy_j(wm.overhead_s, hw) + network_energy_j(wm.wire_bytes, hw),
        overhead_s=wm.overhead_s,
        payload_mb=wm.wire_bytes / 1e6,
    )

    # inference data: sum of inter-stage activations for one cycle
    part = partition(graph, num_nodes, strategy="equal_layers")
    data_bytes = sum(st.out_bytes for st in part.stages)
    wm_d = measure_wire((max(1, data_bytes // 4),), cfg, seed=seed + 1)
    data = ConfigStepReport(
        kind="data", codec=cfg.label,
        energy_j=compute_energy_j(wm_d.overhead_s, hw) + network_energy_j(wm_d.wire_bytes, hw),
        overhead_s=wm_d.overhead_s,
        payload_mb=wm_d.wire_bytes / 1e6,
    )
    return {"architecture": arch, "weights": weights, "data": data}
