"""DEFER model partitioning.

The paper cuts the layer DAG into ``k`` contiguous sub-networks, choosing
layers "based on what would split the model up into a similar number of layers
for each partition".  We implement that strategy (``equal_layers``) plus two
cost-aware ones the dispatcher can plan with:

* ``balanced_flops`` — classic linear-partition DP minimizing the maximum
  per-partition FLOPs (the pipeline bottleneck term),
* ``balanced_latency`` — same DP but on stage *service time* =
  compute_time + outbound transfer time under a :class:`LinkModel`, which is
  the quantity that actually bounds DEFER's steady-state throughput.

All strategies return a :class:`Partition` — the cut indices plus per-stage
cost summaries that the emulator / pipeline runtime consume.

Online recalibration (the serving-time feedback loop) plans on *measured*
costs instead of the static models: :class:`CalibratedCosts` carries
per-layer compute seconds plus per-byte codec/wire rates learned from real
``BatchTrace`` telemetry, :func:`calibrated_partition` re-runs the DP on
them (optionally warm-started in a window around the current cuts, which
also bounds how many layers a live migration has to ship), and
:func:`bounds_bottleneck` is the cost-delta API — it prices *any* candidate
cuts under the same calibrated costs so a controller can compare "stay"
vs "move" before committing a live repartition.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np

from repro_torch.core.graph import LayerGraph

Strategy = Literal["equal_layers", "balanced_flops", "balanced_latency"]


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Per-hop network model (the CORE-emulated Ethernet in the paper)."""

    bandwidth_bytes_per_s: float = 12.5e6     # 100 Mbit Ethernet
    latency_s: float = 2e-4
    energy_per_bit_j: float = 10e-12          # paper: 10 pJ/bit (Ethernet)
    compression_ratio: float = 1.0            # payload multiplier (<1 = compressed)

    def transfer_time(self, payload_bytes: float) -> float:
        wire = payload_bytes * self.compression_ratio
        return self.latency_s + wire / self.bandwidth_bytes_per_s

    def transfer_energy(self, payload_bytes: float) -> float:
        wire = payload_bytes * self.compression_ratio
        return wire * 8.0 * self.energy_per_bit_j


@dataclasses.dataclass(frozen=True)
class ComputeModel:
    """Per-node compute model (an edge CPU in the paper, a TPU chip here)."""

    flops_per_s: float = 20e9                 # edge-class CPU w/ SIMD
    tdp_w: float = 15.0                       # paper's energy = time * TDP

    def compute_time(self, flops: float) -> float:
        return flops / self.flops_per_s


@dataclasses.dataclass
class StageCost:
    start: int                  # node index range [start, stop)
    stop: int
    flops: float
    param_bytes: int
    out_bytes: int              # activation bytes crossing the outbound cut
    compute_time_s: float = 0.0
    transfer_time_s: float = 0.0
    replicas: int = 1           # identical nodes serving this stage

    @property
    def service_time_s(self) -> float:
        # A DEFER node can't accept sample t+1 until it computed AND relayed
        # sample t (single socket thread pair) -> service = compute + transfer.
        # This is the PER-REQUEST time: replicating the stage does not make
        # any single request faster.
        return self.compute_time_s + self.transfer_time_s

    @property
    def throughput_service_s(self) -> float:
        """The stage's effective contribution to the pipeline bottleneck:
        ``replicas`` identical nodes each take a 1/replicas share of the
        request stream, so compute and codec/transfer amortize — but only
        for throughput, never for a request's own latency."""
        return self.service_time_s / self.replicas


@dataclasses.dataclass
class Partition:
    graph_name: str
    cuts: tuple[int, ...]       # k-1 cut indices: cut after node i
    stages: list[StageCost]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def bottleneck_s(self) -> float:
        """Max per-request stage service time (replica-blind: the paper's
        single-node-per-partition law)."""
        return max(s.service_time_s for s in self.stages)

    @property
    def throughput_bottleneck_s(self) -> float:
        """Max replica-amortized stage service time — what actually bounds
        steady-state throughput on a replicated topology."""
        return max(s.throughput_service_s for s in self.stages)

    @property
    def replicas(self) -> tuple[int, ...]:
        return tuple(s.replicas for s in self.stages)

    def ranges(self) -> list[tuple[int, int]]:
        return [(s.start, s.stop) for s in self.stages]


def _computes(compute, num_stages: int) -> list[ComputeModel]:
    """Normalize to one ComputeModel per stage (heterogeneous nodes — the
    paper's stated future work: 'heterogeneous model partitions can be more
    effectively distributed for higher inference throughput')."""
    if isinstance(compute, ComputeModel):
        return [compute] * num_stages
    compute = list(compute)
    assert len(compute) == num_stages, \
        f"{len(compute)} compute models for {num_stages} stages"
    return compute


def _stage_costs(graph: LayerGraph, bounds: Sequence[int],
                 link: LinkModel, computes: list[ComputeModel],
                 replicas: Sequence[int] | None = None) -> list[StageCost]:
    stages: list[StageCost] = []
    for si in range(len(bounds) - 1):
        lo, hi = bounds[si], bounds[si + 1]
        nodes = graph.nodes[lo:hi]
        flops = sum(n.flops for n in nodes)
        pbytes = sum(n.param_bytes for n in nodes)
        obytes = graph.cut_cost(hi - 1) if hi < len(graph.nodes) else nodes[-1].out_bytes
        st = StageCost(lo, hi, flops, pbytes, obytes,
                       replicas=replicas[si] if replicas else 1)
        st.compute_time_s = computes[si].compute_time(flops)
        st.transfer_time_s = link.transfer_time(obytes)
        stages.append(st)
    return stages


def partition(graph: LayerGraph, num_stages: int,
              strategy: Strategy = "balanced_latency",
              link: LinkModel | None = None,
              compute: "ComputeModel | Sequence[ComputeModel] | None" = None,
              cuts: Sequence[int] | None = None,
              replicas: Sequence[int] | None = None) -> Partition:
    """Cut ``graph`` into ``num_stages`` contiguous partitions.

    ``compute`` may be a sequence of per-node models (heterogeneous edge
    cluster): the balanced strategies then assign more work to faster
    nodes (stage i runs on node i — the chain order is fixed by DEFER's
    topology).

    ``cuts`` overrides the strategy with explicit interior cut indices
    (cut after layer ``c``): how a dispatcher rebuilds its Partition after
    a live repartition, and how benchmarks pin a deliberately bad plan.

    ``replicas`` records per-stage replica counts: stage costs price the
    throughput bottleneck as (compute + transfer) / replicas — replication
    amortizes a stage's service RATE, never a single request's latency.
    The strategies themselves still place cuts per-request; the serving
    controller owns the replica dimension.
    """
    link = link or LinkModel()
    computes = _computes(compute or ComputeModel(), num_stages)
    hetero = len({c.flops_per_s for c in computes}) > 1
    n = len(graph.nodes)
    if not 1 <= num_stages <= n:
        raise ValueError(f"num_stages={num_stages} out of range for {n} layers")

    if cuts is not None:
        bounds = [0, *sorted(cuts), n]
        if len(bounds) != num_stages + 1 or len(set(bounds)) != len(bounds) \
                or any(not 0 < c < n for c in cuts):
            raise ValueError(f"cuts {tuple(cuts)} do not split {n} layers "
                             f"into {num_stages} non-empty stages")
    elif strategy == "equal_layers":
        # The paper's strategy: similar number of layers per partition.
        bounds = [round(i * n / num_stages) for i in range(num_stages + 1)]
        bounds = sorted(set(bounds))
        while len(bounds) < num_stages + 1:  # degenerate tiny graphs
            for i in range(len(bounds) - 1):
                if bounds[i + 1] - bounds[i] > 1:
                    bounds.insert(i + 1, bounds[i] + 1)
                    break
    elif strategy in ("balanced_flops", "balanced_latency"):
        if strategy == "balanced_flops" and not hetero:
            w = np.array([node.flops for node in graph.nodes], dtype=np.float64)
            edge = np.zeros(n, dtype=np.float64)
            rates = np.ones(num_stages)
        else:
            w = np.array([node.flops for node in graph.nodes],
                         dtype=np.float64)
            rates = np.array([c.flops_per_s for c in computes])
            if strategy == "balanced_latency":
                edge = np.array(
                    [link.transfer_time(graph.cut_cost(i))
                     for i in range(n - 1)] + [0.0], dtype=np.float64)
            else:
                edge = np.zeros(n, dtype=np.float64)
        bounds = _linear_partition_dp(w, edge, num_stages, rates)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    if replicas is not None and len(replicas) != num_stages:
        raise ValueError(f"{len(replicas)} replica counts for "
                         f"{num_stages} stages")
    stages = _stage_costs(graph, bounds, link, computes, replicas)
    return Partition(graph.name, tuple(bounds[1:-1]), stages)


def _linear_partition_dp(w: np.ndarray, edge: np.ndarray, k: int,
                         rates: np.ndarray | None = None,
                         stage_cost=None,
                         prev_bounds: Sequence[int] | None = None,
                         window: int | None = None) -> list[int]:
    """Minimize the max of (sum of w in stage / rate_j + edge at the cut).

    O(n^2 k) DP — n is layer count (<= a few hundred), fine.
    ``edge[i]`` is the cost charged to a stage whose last node is i
    (the outbound transfer of the cut after node i; edge[n-1] = 0).
    ``rates[j]`` divides stage j's work (heterogeneous nodes); None = 1.

    ``stage_cost(lo, hi, j)`` overrides the additive cost above with an
    arbitrary per-stage pricing (the calibrated staged-runtime max-of-stages
    model); the DP itself only needs costs to be monotone in [lo, hi).

    ``prev_bounds``/``window`` warm-start the search: every interior bound j
    is constrained to ``prev_bounds[j] ± window``.  Besides shrinking the
    search, this caps how many layers a live repartition can shift at once
    (each shifted layer is weights on the wire).  The full DP is the
    ``window=None`` special case.
    """
    n = len(w)
    prefix = np.concatenate([[0.0], np.cumsum(w)])
    if rates is None:
        rates = np.ones(k)

    if stage_cost is None:
        def stage_cost(lo: int, hi: int, j: int) -> float:  # nodes [lo, hi)
            return (prefix[hi] - prefix[lo]) / rates[j] + edge[hi - 1]

    # hi_ok[j][i]: may the boundary after stage j land at layer i?
    hi_ok = np.full((k + 1, n + 1), True)
    if prev_bounds is not None and window is not None:
        for j in range(1, k):
            hi_ok[j] = False
            lo = max(1, prev_bounds[j] - window)
            hi = min(n - 1, prev_bounds[j] + window)
            hi_ok[j][lo:hi + 1] = True

    INF = float("inf")
    # dp[j][i] = minimal bottleneck splitting first i nodes into j stages
    dp = np.full((k + 1, n + 1), INF)
    cut = np.zeros((k + 1, n + 1), dtype=np.int64)
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n - (k - j) + 1):
            if not hi_ok[j][i]:
                continue
            best, arg = INF, j - 1
            for m in range(j - 1, i):
                if dp[j - 1][m] == INF:
                    continue
                c = max(dp[j - 1][m], stage_cost(m, i, j - 1))
                if c < best:
                    best, arg = c, m
            dp[j][i] = best
            cut[j][i] = arg
    if dp[k][n] == INF:        # window too tight to be feasible: full search
        assert window is not None
        return _linear_partition_dp(w, edge, k, rates, stage_cost)
    bounds = [n]
    i = n
    for j in range(k, 0, -1):
        i = int(cut[j][i])
        bounds.append(i)
    return bounds[::-1]


# -- online cost calibration (the serving-time feedback loop) ----------------

@dataclasses.dataclass
class CalibratedCosts:
    """Measured serving costs, in seconds, for pricing candidate cuts.

    ``layer_s[i]`` is the calibrated compute time of layer i for one
    request (EWMA of real per-node apply time, spread over the node's
    layer range by static FLOPs share).  The codec/wire rates convert a
    cut's crossing bytes (``cut_bytes[i]``, static graph property) into
    per-request encode time at the sender and decode time at the receiver
    — both measured amortized over real batches, so batching efficiency is
    priced in.  ``head_in_bytes`` is what stage 0 decodes (the admitted
    input); ``tail_out_bytes`` is what the last stage encodes for the
    collector.
    """

    layer_s: np.ndarray                 # [n] per-layer compute seconds
    cut_bytes: np.ndarray               # [n] bytes crossing cut after layer i
    encode_s_per_byte: float = 0.0
    decode_s_per_byte: float = 0.0
    wire_s_per_byte: float = 0.0        # modeled link time (0 = in-process)
    head_in_bytes: float = 0.0
    tail_out_bytes: float = 0.0

    def __post_init__(self):
        # prefix sums make stage_service_s O(1): the DP calls it O(n^2 k)
        # times per re-plan, every control period, possibly on 100+-layer
        # graphs — an O(n) slice-sum inside would steal whole cores from
        # serving
        self._prefix = np.concatenate([[0.0], np.cumsum(self.layer_s)])

    def stage_service_s(self, lo: int, hi: int, staged: bool = True,
                        replicas: int = 1) -> float:
        """Predicted service time of a stage covering layers [lo, hi).

        A staged node overlaps its decode / compute / encode threads, so
        its steady-state service rate is set by the *max* stage time
        (paper: throughput = 1 / max_i service_i); an unstaged node pays
        the sum.  ``replicas`` identical nodes split the request stream,
        so compute and codec amortize by 1/replicas — for the stage's
        service RATE, which is what this function prices; a request's own
        latency through one replica is unchanged by its siblings.
        """
        in_b = self.head_in_bytes if lo == 0 else float(self.cut_bytes[lo - 1])
        out_b = (self.tail_out_bytes if hi == len(self.layer_s)
                 else float(self.cut_bytes[hi - 1]))
        dec = self.decode_s_per_byte * in_b
        cmp = float(self._prefix[hi] - self._prefix[lo])
        enc = (self.encode_s_per_byte + self.wire_s_per_byte) * out_b
        per_req = max(dec, cmp, enc) if staged else dec + cmp + enc
        return per_req / max(1, replicas)


def bounds_bottleneck(costs: CalibratedCosts, bounds: Sequence[int],
                      staged: bool = True,
                      replicas: Sequence[int] | None = None) -> float:
    """Cost-delta API: predicted bottleneck service time of ANY cuts under
    the calibrated costs — price the current plan and a candidate with the
    same ruler before paying for a live migration.  ``replicas`` prices a
    replicated topology (stage i's rate amortized by replicas[i])."""
    return max(costs.stage_service_s(lo, hi, staged,
                                     replicas[j] if replicas else 1)
               for j, (lo, hi) in enumerate(zip(bounds, bounds[1:])))


def calibrated_partition(costs: CalibratedCosts, num_stages: int,
                         staged: bool = True,
                         prev_bounds: Sequence[int] | None = None,
                         window: int | None = None,
                         replicas: Sequence[int] | None = None
                         ) -> tuple[list[int], float]:
    """Re-run the partition DP on calibrated (measured) costs.

    Returns ``(bounds, predicted_bottleneck_s)``.  ``prev_bounds`` +
    ``window`` warm-start the DP around the live cuts (bounding both the
    search and the weight bytes a migration ships); infeasible windows
    fall back to the full search.  ``replicas`` makes the DP place cuts
    for the CURRENT replicated topology: a 2-replica stage can profitably
    hold twice the layers (its service rate halves), which a replica-blind
    plan would miscount as the bottleneck.
    """
    n = len(costs.layer_s)

    def stage_cost(lo: int, hi: int, j: int) -> float:
        return costs.stage_service_s(lo, hi, staged,
                                     replicas[j] if replicas else 1)

    bounds = _linear_partition_dp(
        costs.layer_s, np.zeros(n), num_stages, stage_cost=stage_cost,
        prev_bounds=prev_bounds, window=window)
    return bounds, bounds_bottleneck(costs, bounds, staged, replicas)
