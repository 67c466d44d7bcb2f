"""Hardware constants and energy accounting (the twin of
``repro.core.metrics``).

Three hardware profiles:

* EDGE  — the paper's setting: edge-class CPU nodes on emulated Ethernet
          (CORE).  Energy model is the paper's: serialization time x TDP
          plus 10 pJ/bit network energy.
* H100  — the port's target, one NVIDIA H100 SXM: data-sheet peaks (f32
          outside the tensor cores, since the port computes in f32 with
          TF32 off), its 700 W power limit and PCIe Gen5 x16 to the host.
          The default of :func:`roofline`.
* TPU_V5E — the reference package's roofline target, kept for parity
          with it; none of its figures is the port's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float              # FLOP/s (per node / chip)
    hbm_bw: float                  # bytes/s
    link_bw: float                 # bytes/s per link
    tdp_w: float
    energy_per_bit_j: float
    # baseline draw of a powered-on node doing nothing (W).  The paper's
    # per-node energy is measured on nodes that exist whether or not they
    # are busy — an IDLE replica of an over-provisioned stage still burns
    # this.  Default 0 keeps every pre-replica energy figure unchanged;
    # replica-aware accounting (emulate(replicas=...) / EngineReport
    # idle_energy_j) prices it when a profile sets it.
    idle_w: float = 0.0


def idle_energy_j(idle_s: float, hw: HardwareProfile) -> float:
    """Baseline burn of a powered-on but idle node over ``idle_s``."""
    return max(0.0, idle_s) * hw.idle_w


EDGE = HardwareProfile(
    name="edge-cpu",
    peak_flops=20e9,               # edge CPU w/ SIMD (Raspberry-Pi-4-class x4)
    hbm_bw=8e9,
    link_bw=12.5e6,                # 100 Mbit Ethernet
    tdp_w=15.0,
    energy_per_bit_j=10e-12,       # paper: 10 pJ/bit Ethernet
)

H100 = HardwareProfile(
    name="h100-sxm",
    peak_flops=67e12,              # f32, non-tensor-core (data sheet)
    hbm_bw=3.35e12,                # HBM3 (data sheet)
    link_bw=64e9,                  # PCIe Gen5 x16, one direction (data sheet)
    tdp_w=700.0,                   # the power limit nvidia-smi reports
    energy_per_bit_j=10e-12,       # assumption: the paper's 10 pJ/bit; no
                                   # published per-bit figure for the link
)

# the reference's roofline target, kept for parity with repro.core.metrics
TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    peak_flops=197e12,             # bf16
    hbm_bw=819e9,
    link_bw=50e9,                  # per ICI link
    tdp_w=170.0,
    energy_per_bit_j=3e-12,        # ICI-class serdes
)


def compute_energy_j(time_s: float, hw: HardwareProfile) -> float:
    """Paper's methodology: busy time x TDP."""
    return time_s * hw.tdp_w


def network_energy_j(payload_bytes: float, hw: HardwareProfile) -> float:
    """Paper's methodology: payload x energy-per-bit."""
    return payload_bytes * 8.0 * hw.energy_per_bit_j


@dataclasses.dataclass
class LatencySummary:
    """Request-latency distribution over a serving window."""

    count: int
    mean_s: float
    p50_s: float
    p99_s: float

    @staticmethod
    def from_values(values) -> "LatencySummary":
        import numpy as np
        if not len(values):
            return LatencySummary(0, 0.0, 0.0, 0.0)
        a = np.asarray(values, dtype=float)
        return LatencySummary(int(a.size), float(a.mean()),
                              float(np.percentile(a, 50)),
                              float(np.percentile(a, 99)))


@dataclasses.dataclass
class RooflineTerms:
    """The three per-step roofline terms (seconds), per the assignment."""

    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             chips: int, hw: HardwareProfile = H100) -> RooflineTerms:
    return RooflineTerms(
        compute_s=hlo_flops / (chips * hw.peak_flops),
        memory_s=hlo_bytes / (chips * hw.hbm_bw),
        collective_s=collective_bytes / (chips * hw.link_bw),
    )
