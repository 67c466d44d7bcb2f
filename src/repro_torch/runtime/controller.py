"""Serving-time feedback controller: close the loop between measurement
and planning (the twin of ``repro.runtime.controller``: the same
configuration, calibration and decisions, bit for bit on the same
telemetry).

DEFER's steady-state throughput is ``1 / max_i service_i`` — it is set by
the slowest stage.  The dispatcher plans the chain ONCE, offline, from
static :class:`~repro_torch.core.partitioner.ComputeModel` /
:class:`~repro_torch.core.partitioner.LinkModel` guesses; meanwhile every node
already *measures* its real per-stage decode / compute / encode time per
batch (:class:`~repro_torch.runtime.node.BatchTrace` + per-stage busy counters).
This module feeds those measurements back into the plan while the chain is
serving:

1. **Calibrate** (:class:`CostCalibrator`): EWMA per-*layer* compute
   seconds (each node's measured per-request apply time, spread over its
   layer range by static FLOPs share) and per-*byte* codec rates (encode
   at the sender, decode at the receiver, amortized over real batches, so
   batching efficiency is priced in).  Together these price ANY candidate
   cut, not just the ones currently in use.  On a CUDA device a node's
   ``compute_s`` ends with the device-to-host copy of the stage's
   outputs, which waits for the device: the calibrator prices the work
   the card did, not the time its launches took.

2. **Re-plan** (:func:`decide_repartition`): periodically re-run the
   ``balanced_latency`` DP on the calibrated costs — warm-started in a
   window around the live cuts, which bounds both the search and the
   weight bytes a migration would ship — and compare the predicted
   bottleneck against the current plan priced with the SAME costs (the
   partitioner's cost-delta API).  Only when the predicted improvement
   clears a hysteresis threshold does the controller commit; noise in the
   telemetry therefore cannot thrash the chain.

3. **Migrate** (:meth:`Dispatcher.reconfigure`): commit by shipping only
   the shifted layers' weights to the affected neighbors and fencing the
   switch with a :class:`~repro_torch.runtime.wire.ReconfigMarker` epoch marker
   on the wire — zero in-flight requests are dropped or recomputed.

4. **Adapt knobs** (:func:`suggest_knobs`): retune each stage's
   ``max_batch`` and ingress ``coalesce_s`` window (uniformly across its
   replicas) from its measured codec/compute stage-time ratio instead of
   the static 8 / 5 ms defaults: a codec-bound stage grows its coalescing
   window (bigger waves = fewer codec passes, and compute is idle anyway),
   a compute-bound stage shrinks it back toward zero to cut queueing
   latency.

5. **Scale replicas** (:func:`decide_scale`): when the calibrated DP says
   the bottleneck stage CANNOT be fixed by moving cuts (the repartition
   arm holds), the controller prices the topology with the replica-aware
   ruler (stage rate = per-request service / replicas) and recommends —
   or, behind ``execute_scaling``, commits via ``Dispatcher.scale`` — a
   replica change on the bottleneck stage; over-replicated stages shed a
   replica symmetrically.  This is the SEIFER insight: past some point
   the throughput win comes from replicating partitions, not re-cutting
   them.

The controller is deliberately conservative: it acts only on windows with
enough requests, respects a cooldown between migrations, and every
decision (including "hold") is recorded in :attr:`Controller.actions` so
benchmarks and tests can audit the loop.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import TYPE_CHECKING, Sequence

import numpy as np

from repro_torch.core.graph import LayerGraph, tree_bytes
from repro_torch.core.partitioner import (CalibratedCosts, ComputeModel,
                                          LinkModel, bounds_bottleneck,
                                          calibrated_partition)

if TYPE_CHECKING:                      # import cycle: dispatcher is runtime
    from repro_torch.runtime.dispatcher import Dispatcher


@dataclasses.dataclass
class ControllerConfig:
    """Knobs of the feedback loop itself (not of the nodes it tunes)."""

    interval_s: float = 0.5            # control period
    ewma_alpha: float = 0.4            # calibration smoothing (1 = no memory)
    hysteresis: float = 0.15           # min predicted bottleneck improvement
    min_requests: int = 32             # min per-node window requests before
                                       # a re-plan may commit
    cooldown_s: float = 2.0            # min time between live migrations
    window: int | None = None          # warm-start DP: cut shift cap (layers)
    repartition: bool = True           # enable the live-migration arm
    adapt_knobs: bool = True           # enable the max_batch/coalesce_s arm
    knob_min_requests: int = 4         # per-node interval gate for knob moves
    coalesce_bounds: tuple = (0.0005, 0.04)   # [s] adaptive window clamp
    precompile_after_swap: bool = True # warm new shapes off the hot path
    model_wire: bool = False           # include modeled link time in costs
                                       # (False: in-process wire is free)
    # the replica dimension: when cuts can't fix the bottleneck, recommend
    # (replica_scaling) or commit (execute_scaling) a replica change
    replica_scaling: bool = False      # enable the scale arm
    execute_scaling: bool = False      # actually call Dispatcher.scale
    max_replicas: int = 4              # per-stage replica ceiling
    scale_up_ratio: float = 1.5        # bottleneck rate >= ratio * runner-up
    scale_down_ratio: float = 2.0      # shed only when r-1 stays this far
                                       # under the bottleneck


@dataclasses.dataclass
class ControllerAction:
    """One control decision, kept for audit (tests, benchmarks, reports)."""

    t: float                           # perf_counter at decision time
    kind: str                          # "repartition" | "knobs" | "hold"
    detail: dict


class CostCalibrator:
    """Online EWMA calibration of the partitioner's cost inputs.

    Seeds from the static models (so the first ``costs()`` is exactly the
    offline planner's view) and refines toward measured reality with every
    telemetry window: per-layer compute seconds from each node's measured
    per-request apply time, per-byte encode/decode rates from the codec
    stages.  ``ready`` flips once at least one real window with traffic on
    every node has been folded in — before that, re-planning would just
    echo the static plan's own assumptions back at it.
    """

    def __init__(self, graph: LayerGraph, alpha: float = 0.4,
                 compute: ComputeModel | None = None,
                 link: LinkModel | None = None,
                 model_wire: bool = False):
        self.graph = graph
        self.alpha = alpha
        self.link = link or LinkModel()
        self.model_wire = model_wire
        n = len(graph.nodes)
        compute = compute or ComputeModel()
        self.flops = np.array([nd.flops for nd in graph.nodes], np.float64)
        # static seed: the offline planner's per-layer guess
        self.layer_s = self.flops / compute.flops_per_s
        self.cut_bytes = np.array(
            [graph.cut_cost(i) for i in range(n - 1)]
            + [graph.nodes[-1].out_bytes], np.float64)
        self.head_in_bytes = float(tree_bytes(graph.input_spec))
        self.tail_out_bytes = float(graph.nodes[-1].out_bytes)
        self.encode_s_per_byte = 0.0
        self.decode_s_per_byte = 0.0
        self._nodes_seen: set[int] = set()
        self._num_nodes: int | None = None
        self.updates = 0

    @property
    def ready(self) -> bool:
        return (self._num_nodes is not None
                and len(self._nodes_seen) >= self._num_nodes)

    def _ewma(self, old: float, sample: float) -> float:
        return (1.0 - self.alpha) * old + self.alpha * sample

    def update(self, snapshots: Sequence[dict],
               ranges: Sequence[tuple]) -> None:
        """Fold one telemetry window (``ComputeNode.snapshot()`` per node,
        plus the node's current layer range) into the calibration."""
        self._num_nodes = len(snapshots)
        for snap, (lo, hi) in zip(snapshots, ranges):
            n = snap["n"]
            if n <= 0:
                continue
            self._nodes_seen.add(snap["node"])
            # per-request compute, spread over the range by FLOPs share
            # (zero-FLOP ranges spread uniformly)
            per_req = snap["compute_s"] / n
            shares = self.flops[lo:hi]
            total = shares.sum()
            shares = (shares / total if total > 0
                      else np.full(hi - lo, 1.0 / (hi - lo)))
            for j, share in zip(range(lo, hi), shares):
                self.layer_s[j] = self._ewma(self.layer_s[j],
                                             per_req * share)
            # per-byte codec rates at this node's live cuts; amortization
            # from batching is embedded because serialize/deserialize_s
            # are window totals over n requests
            out_b = (self.tail_out_bytes if hi == len(self.layer_s)
                     else self.cut_bytes[hi - 1])
            if out_b > 0 and snap["serialize_s"] > 0:
                self.encode_s_per_byte = self._ewma(
                    self.encode_s_per_byte, snap["serialize_s"] / n / out_b)
            in_b = (self.head_in_bytes if lo == 0
                    else self.cut_bytes[lo - 1])
            if in_b > 0 and snap["deserialize_s"] > 0:
                self.decode_s_per_byte = self._ewma(
                    self.decode_s_per_byte,
                    snap["deserialize_s"] / n / in_b)
        self.updates += 1

    def costs(self) -> CalibratedCosts:
        return CalibratedCosts(
            layer_s=self.layer_s.copy(),
            cut_bytes=self.cut_bytes,
            encode_s_per_byte=self.encode_s_per_byte,
            decode_s_per_byte=self.decode_s_per_byte,
            wire_s_per_byte=(1.0 / self.link.bandwidth_bytes_per_s
                            if self.model_wire else 0.0),
            head_in_bytes=self.head_in_bytes,
            tail_out_bytes=self.tail_out_bytes,
        )


def decide_repartition(costs: CalibratedCosts, cur_bounds: Sequence[int],
                       num_stages: int, staged: bool = True,
                       hysteresis: float = 0.15,
                       window: int | None = None,
                       replicas: Sequence[int] | None = None) -> dict | None:
    """Pure decision: is a migration worth it under the calibrated costs?

    Prices the CURRENT cuts and the DP's best candidate with the same
    calibrated ruler (the cost-delta API) and returns a decision record
    only when the predicted bottleneck improves by more than
    ``hysteresis`` — the deadband that keeps telemetry noise from
    thrashing the chain with migrations.  ``replicas`` prices both plans
    for the live replicated topology (a 2-replica stage runs at half its
    per-request time, so cuts should lean layers INTO it).
    """
    cur_pred = bounds_bottleneck(costs, cur_bounds, staged, replicas)
    new_bounds, new_pred = calibrated_partition(
        costs, num_stages, staged=staged, prev_bounds=cur_bounds,
        window=window, replicas=replicas)
    if tuple(new_bounds) == tuple(cur_bounds):
        return None
    if new_pred >= cur_pred * (1.0 - hysteresis):
        return None
    return {
        "bounds": new_bounds,
        "cuts": tuple(new_bounds[1:-1]),
        "predicted_current_s": cur_pred,
        "predicted_new_s": new_pred,
        "predicted_gain": cur_pred / new_pred if new_pred > 0 else float("inf"),
    }


def decide_scale(costs: CalibratedCosts, bounds: Sequence[int],
                 replicas: Sequence[int], staged: bool = True,
                 max_replicas: int = 4, up_ratio: float = 1.5,
                 down_ratio: float = 2.0) -> dict | None:
    """Pure decision: should a stage's replica count change?

    Called only after :func:`decide_repartition` held — cuts alone cannot
    fix the bottleneck.  Prices every stage's effective service RATE
    (per-request time / replicas) under the calibrated costs:

    * **up**: the bottleneck stage's rate is at least ``up_ratio`` x the
      runner-up's — moving cuts already couldn't close that gap, so one
      more replica on the bottleneck is the remaining lever (capped at
      ``max_replicas``);
    * **down**: a multi-replica stage that would STILL sit ``down_ratio``
      x under the bottleneck with one replica fewer is over-provisioned —
      shed one (throughput is set by the bottleneck; idle replicas only
      burn energy, the paper's per-node metric).
    """
    ranges = list(zip(bounds, bounds[1:]))
    eff = [costs.stage_service_s(lo, hi, staged, r)
           for (lo, hi), r in zip(ranges, replicas)]
    order = sorted(range(len(eff)), key=lambda i: eff[i], reverse=True)
    b = order[0]
    runner_up = eff[order[1]] if len(order) > 1 else 0.0
    # no runner-up (single stage, or a ~free second stage) means no
    # measured imbalance to justify a spawn — an unconditional up would
    # grow an idle single-stage engine to max_replicas on pure cost noise
    if (runner_up > 0.0 and replicas[b] < max_replicas
            and eff[b] >= up_ratio * runner_up):
        return {"stage": b, "replicas": replicas[b] + 1,
                "direction": "up",
                "predicted_stage_s": eff[b],
                "predicted_after_s": eff[b] * replicas[b]
                / (replicas[b] + 1),
                "runner_up_s": runner_up}
    for s in order[::-1]:                     # coldest stages first
        r = replicas[s]
        if s == b or r <= 1:
            continue
        shed = eff[s] * r / (r - 1)           # rate at r-1 replicas
        if shed * down_ratio <= eff[b]:
            return {"stage": s, "replicas": r - 1,
                    "direction": "down",
                    "predicted_stage_s": eff[s],
                    "predicted_after_s": shed,
                    "bottleneck_s": eff[b]}
    return None


def suggest_knobs(snap: dict, cap: int,
                  coalesce_bounds: tuple = (0.0005, 0.04)) -> tuple[int, float]:
    """Adaptive batching law: retune (max_batch, coalesce_s) from the
    measured codec/compute stage-time ratio.

    * codec-bound (decode+encode busy > compute busy) WITH a real backlog
      (queued arrivals, batches not already full): growing the ingress
      coalescing window merges more requests per wave, so the expensive
      codec runs once per wave instead of once per trickle.  The window is
      additionally capped by the node's measured per-wave service time —
      coalescing longer than one wave takes to process would starve the
      downstream stages instead of hiding behind them.  A backlogged node
      with full batches also raises max_batch toward the cap.
    * compute-bound (ratio < 1/2), or no backlog to merge: shrink the
      window back toward zero — waves can't amortize anything worth the
      queueing latency they add.

    Multiplicative 1.5x steps per control period give smooth convergence;
    the clamps keep the knobs inside sane serving ranges.
    """
    mb, co = snap["max_batch"], snap["coalesce_s"]
    cmp_busy = snap["busy_compute_s"]
    codec_busy = snap["busy_decode_s"] + snap["busy_encode_s"]
    if cmp_busy + codec_busy <= 0:
        return mb, co
    lo, hi = coalesce_bounds
    ratio = codec_busy / max(cmp_busy, 1e-9)
    backlog = snap["queue_depth_mean"]
    waves = max(1.0, snap["n"] / max(snap["batch_mean"], 1e-9))
    wave_service_s = (cmp_busy + codec_busy) / waves
    if ratio > 1.0 and backlog > 1.5:
        if snap["batch_mean"] < 0.75 * mb:
            # waves aren't filling: a longer window merges more per wave
            co = min(hi, max(co, lo) * 1.5, wave_service_s)
        if backlog > 0.5 * mb and snap["batch_mean"] > 0.5 * mb:
            # waves ARE filling and work keeps queueing: the batch size
            # itself is the binding constraint, raise it toward the cap
            # (independent of the coalesce branch — a saturated node with
            # batch_mean == mb must still be able to grow)
            mb = min(cap, mb * 2)
    elif ratio < 0.5 or backlog <= 1.0:
        co = max(lo, co / 1.5)
        if (ratio < 0.5 and snap["batch_mean"] < 0.25 * mb
                and backlog <= 1.0):
            mb = max(1, mb // 2)
    return mb, co


class Controller:
    """The feedback thread tying calibration, planning, and actuation
    together over a live :class:`~repro_torch.runtime.dispatcher.Dispatcher`.

    ``step()`` is one full control period and is callable directly (no
    thread) — that is how tests drive deterministic scenarios and how a
    benchmark can force convergence checks.
    """

    def __init__(self, dispatcher: "Dispatcher",
                 config: ControllerConfig | None = None):
        self.dispatcher = dispatcher
        self.cfg = config or ControllerConfig()
        self.calibrator = CostCalibrator(
            dispatcher.graph, alpha=self.cfg.ewma_alpha,
            link=dispatcher.link, model_wire=self.cfg.model_wire)
        self.actions: list[ControllerAction] = []
        self.migrations = 0
        self._last_migration_t = float("-inf")
        # per-interval windowing: node stats are cumulative (the engine's
        # report window owns their reset), so each step diffs against the
        # previous snapshot and calibrates on the interval's delta only
        self._prev: list[dict] | None = None
        self._accum_n = 0              # evidence since the last migration
        self._skip_update = False      # the interval spanning a migration
                                       # mixes two partitions' telemetry
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.cfg.interval_s):
            try:
                self.step()
            except Exception:            # a sick controller must not kill
                import traceback         # the serving chain it watches
                self.actions.append(ControllerAction(
                    time.perf_counter(), "error",
                    {"traceback": traceback.format_exc()}))

    # -- one control period ---------------------------------------------------
    _COUNTERS = ("n", "compute_s", "serialize_s", "deserialize_s",
                 "payload_bytes", "encodes", "busy_decode_s",
                 "busy_compute_s", "busy_encode_s", "waves", "depth_sum",
                 "depth_count")

    def _stage_snapshot(self, group) -> dict:
        """One telemetry view per STAGE: replica counters summed (time
        totals and request counts are additive across the replicas that
        split the stream), knobs read from replica 0 (set uniformly), and
        the epoch as the MIN over replicas — the stage has fully adopted a
        fence only when its slowest replica has.  live_replicas() prunes
        dead retirees, whose frozen epochs would otherwise read as a
        permanently lagging fence."""
        snaps = [r.snapshot() for r in group.live_replicas()]
        agg = {k: sum(s[k] for s in snaps) for k in self._COUNTERS}
        agg["node"] = group.index
        agg["replicas"] = len(snaps)
        agg["epoch"] = min(s["epoch"] for s in snaps)
        agg["max_batch"] = snaps[0]["max_batch"]
        agg["coalesce_s"] = snaps[0]["coalesce_s"]
        agg["batch_mean"] = (agg["n"] / agg["waves"] if agg["waves"]
                             else 0.0)
        agg["queue_depth_mean"] = (agg["depth_sum"] / agg["depth_count"]
                                   if agg["depth_count"] else 0.0)
        return agg

    @classmethod
    def _delta(cls, prev: dict | None, cur: dict) -> dict:
        """This interval's telemetry: cumulative counters diffed against
        the previous snapshot, with the derived means (batch occupancy,
        queue depth) rebuilt from the interval's own sums so every signal
        shares one time base.

        A counter that went DOWN means the baseline is gone — the engine
        reset its report window, or a drained replica left the stage's
        aggregate (a manual ``scale()`` is not guarded by the fence-lag
        rebaseline if it cleared between control periods).  Either way
        the current cumulative values are NOT one interval's telemetry,
        so the interval is zeroed (skipped) rather than fed to the
        calibrator as a giant fake window; the next tick diffs cleanly
        against the new baseline."""
        if prev is None:
            out = dict(cur)
        else:
            out = dict(cur)
            deltas = {k: cur[k] - prev[k] for k in cls._COUNTERS}
            if any(v < 0 for v in deltas.values()):
                deltas = {k: 0 for k in cls._COUNTERS}
            out.update(deltas)
        out["batch_mean"] = (out["n"] / out["waves"] if out["waves"]
                             else 0.0)
        out["queue_depth_mean"] = (out["depth_sum"] / out["depth_count"]
                                   if out["depth_count"] else 0.0)
        return out

    def step(self) -> ControllerAction:
        d = self.dispatcher
        cfg = self.cfg
        now = time.perf_counter()
        raw = [self._stage_snapshot(g) for g in d.stages]
        prev = self._prev or [None] * len(raw)
        snaps = [self._delta(p, r) for p, r in zip(prev, raw)]
        self._prev = raw
        # an epoch fence can take several intervals to clear a backlogged
        # chain: while any replica still runs the old partition /
        # membership — and for one interval after the last one catches up
        # (that interval's telemetry straddles both) — rebaseline only
        lagging = any(s["epoch"] < d.epoch for s in raw)
        if lagging or self._skip_update:
            self._skip_update = lagging
            action = ControllerAction(now, "rebaseline",
                                      {"epoch": d.epoch,
                                       "fence_in_flight": lagging})
            self.actions.append(action)
            return action
        ranges = d.partition.ranges()
        self.calibrator.update(snaps, ranges)
        # every request traverses every stage, so the interval's size is
        # the MIN per-stage count (summing would count each request k
        # times); evidence accumulates across intervals until a decision
        window_n = min((s["n"] for s in snaps), default=0)
        self._accum_n += window_n

        knob_moves = []
        if cfg.adapt_knobs:
            for i, snap in enumerate(snaps):
                if snap["n"] < cfg.knob_min_requests:
                    continue
                cap = d.stages[i].replicas[0].max_batch_cap
                mb, co = suggest_knobs(snap, cap, cfg.coalesce_bounds)
                if mb != snap["max_batch"] or co != snap["coalesce_s"]:
                    d.set_stage_knobs(i, max_batch=mb, coalesce_s=co)
                    knob_moves.append({"stage": i, "max_batch": mb,
                                       "coalesce_s": co})

        staged = d.stages[0].replicas[0].staged
        reps = list(d.replicas)
        bounds = [0, *d.partition.cuts, len(d.graph.nodes)]
        gate_ok = (self.calibrator.ready
                   and self._accum_n >= cfg.min_requests
                   and now - self._last_migration_t >= cfg.cooldown_s)
        decision = None
        if cfg.repartition and gate_ok:
            decision = decide_repartition(
                self.calibrator.costs(), bounds, len(d.stages),
                staged=staged, hysteresis=cfg.hysteresis,
                window=cfg.window, replicas=reps)
        scale_rec = None
        if decision is None and cfg.replica_scaling and gate_ok:
            # cuts can't fix the bottleneck (the DP held): the replica
            # dimension is the remaining lever
            scale_rec = decide_scale(
                self.calibrator.costs(), bounds, reps, staged=staged,
                max_replicas=cfg.max_replicas,
                up_ratio=cfg.scale_up_ratio,
                down_ratio=cfg.scale_down_ratio)
        if decision is not None:
            record = d.reconfigure(decision["cuts"])
            self._last_migration_t = time.perf_counter()
            self.migrations += 1
            self._accum_n = 0
            self._skip_update = True
            if cfg.precompile_after_swap and record.get("acknowledged"):
                # warm the swapped stages' new batch shapes from the
                # controller thread, concurrent with serving: cuDNN/cuBLAS
                # algorithm choice, the q8 kernels' build and the caching
                # allocator's growth then never land on the hot path
                for i in record["nodes_touched"]:
                    for node in d.stages[i].replicas:
                        node.precompile()
            action = ControllerAction(now, "repartition",
                                      {**decision, **record,
                                       "knobs": knob_moves})
        elif scale_rec is not None and cfg.execute_scaling:
            record = d.scale(scale_rec["stage"], scale_rec["replicas"],
                             precompile=cfg.precompile_after_swap)
            self._last_migration_t = time.perf_counter()
            self.migrations += 1
            self._accum_n = 0
            self._skip_update = True
            action = ControllerAction(now, "scale",
                                      {**scale_rec, **record,
                                       "knobs": knob_moves})
        elif scale_rec is not None:
            # recommendation only: surfaced (and paced by the cooldown)
            # for an operator or an external autoscaler to act on
            self._last_migration_t = time.perf_counter()
            action = ControllerAction(now, "scale_recommend",
                                      {**scale_rec, "knobs": knob_moves})
        elif knob_moves:
            action = ControllerAction(now, "knobs", {"knobs": knob_moves})
        else:
            action = ControllerAction(now, "hold", {"requests": window_n})
        self.actions.append(action)
        return action
