"""Top-level DEFER inference engine + measured metrics report.

``InferenceEngine`` is the public, topology-first API the examples use:
declare the serving shape as a :class:`~repro_torch.runtime.topology.TopologySpec`
(stages x replicas x transports — or pass an int for the classic
one-replica chain), build the engine from a layer graph, then either

* ``submit(x, client_id)`` / ``submit_stream(xs, client_id)`` — the async
  serving path: many clients admit requests concurrently, compute replicas
  batch them continuously, results come back as futures (FIFO per client —
  the collector's sequenced merge holds replica-reordered completions),
* ``generate(prompt, max_new_tokens)`` — autoregressive decode serving:
  one session's tokens stream back as they exit the tail, with per-stage
  KV caches resident on the replicas (see :mod:`repro_torch.runtime.session`), or
* ``run(xs)`` — the original blocking single-stream call, now a shim over
  submit().

Topology is LIVE: ``scale(stage, n)`` grows or drains a stage's replica
count behind the epoch fence with zero dropped or per-client-reordered
responses — the node-count elasticity the chain-shaped API could not
express.

The report carries the paper's four metrics — throughput, per-node energy,
overhead, payload — from measured timings plus the link model for wire
time/energy (the part CORE emulates in the original), and the serving
ones: per-replica *per-stage* utilization (decode / compute / encode busy
fractions of the measurement-window wall clock, so the staged codec/compute
overlap is visible), queue depth, batch occupancy, and p50/p99 request
latency, so the paper's ``1/max_i service_i`` law — amortized by replica
counts — is observable under real multi-client load.

Utilizations come in two flavors per stage: the clamped ``util_*`` (a
fraction of the window, capped at 1.0 for dashboard sanity) and the raw
``util_*_raw`` (busy / wall, uncapped).  On an oversubscribed host a busy
counter can legitimately exceed the wall clock — stage threads count
runnable-but-descheduled time — and the serving controller needs to SEE
that oversubscription honestly to avoid tuning against a saturated lie.

The report also reads, over the window, the CPU time of every thread the
chain started (``thread_cpu_s``, by thread name) beside the whole
process's, and the decode steps' waits in each queue (``step_wait_s``);
each replica's entry carries its decode counters over the window as the
replica reads them out
(:meth:`~repro_torch.runtime.node.ComputeNode.window_report`).
``start_spans`` / ``stop_spans`` record the chain's spans
(:mod:`repro_torch.runtime.spans`), off otherwise.

With ``controller=ControllerConfig(...)`` the engine runs the serving-time
feedback loop (:mod:`repro_torch.runtime.controller`): online cost
calibration from this report's raw telemetry, periodic re-planning of the
partition on measured costs, hot repartitioning behind an epoch fence,
adaptive ``max_batch`` / ``coalesce_s`` per stage — and, when enabled, the
replica dimension: scale recommendations (or executions) for bottleneck
stages the calibrated DP cannot fix by moving cuts.  Compute and codec
kernels run on the engine's ``device``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from concurrent.futures import Future
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.graph import LayerGraph
from repro_torch.core.metrics import (EDGE, HardwareProfile, LatencySummary,
                                      compute_energy_j, idle_energy_j,
                                      network_energy_j)
from repro_torch.core.partitioner import LinkModel
from repro_torch.runtime.controller import Controller, ControllerConfig
from repro_torch.runtime.dispatcher import (Dispatcher, DispatcherCodecs,
                                            RetryPolicy)
from repro_torch.runtime.session import generate_tokens
from repro_torch.runtime.spans import Spans, thread_cpu_s, window_cpu_s
from repro_torch.runtime.topology import TopologySpec
from repro_torch.runtime.wire import CHUNK_BYTES


@dataclasses.dataclass
class EngineReport:
    model: str
    num_nodes: int                     # total live replicas across stages
    codec: str
    samples: int
    wall_s: float
    throughput_cps: float              # measured inference cycles / second
    modeled_throughput_cps: float      # incl. modeled wire time (paper setting)
    per_node_energy_j: float
    overhead_s: float                  # serialize+deserialize per cycle
    payload_mb: float                  # inter-node payload per cycle
    p50_latency_s: float               # admission -> result, this window
    p99_latency_s: float
    per_node: list[dict]               # one entry per replica, stage-major
    cuts: tuple = ()                   # live partition cut indices
    replicas: tuple = ()               # live per-stage replica counts
    epoch: int = 0                     # committed live fences so far
    # CPU s over the window of each live thread the chain started, by
    # name (defer-s{i}r{j}-ingress, defer-route-s{i}, defer-pump, ...),
    # and of the whole process: the rest is the callers', torch's and the
    # CUDA driver's threads
    thread_cpu_s: dict = dataclasses.field(default_factory=dict)
    process_cpu_s: float = 0.0
    # decode steps' waits over the window, s times steps: "admission",
    # "s{i}.inbox", "s{i}.to_compute", "s{i}.to_encode", "result"
    step_wait_s: dict = dataclasses.field(default_factory=dict)


class InferenceEngine:
    def __init__(self, graph: LayerGraph,
                 topology: TopologySpec | int,
                 codecs: DispatcherCodecs | None = None,
                 hw: HardwareProfile = EDGE,
                 link: LinkModel | None = None,
                 max_batch: int = 8,
                 admission_depth: int = 64,
                 queue_depth: int = 8,
                 client_quota: int | None = None,
                 shape_buckets: str = "exact",
                 max_batch_cap: int | None = None,
                 controller: ControllerConfig | None = None,
                 replica_factory=None,
                 retry_policy: RetryPolicy | None = None,
                 device: str | torch.device | None = None):
        """``topology`` is the serving shape: a
        :class:`~repro_torch.runtime.topology.TopologySpec`, or an int ``n`` as
        shorthand for ``TopologySpec.chain(graph, n)`` (the paper's
        one-replica equal-layers chain).  Strategy, explicit cuts, and
        per-stage overrides all live on the spec, not here.

        ``device`` is where every replica computes and every codec kernel
        runs: CUDA by default (raising if it is unavailable), the CPU only
        when asked for."""
        if isinstance(topology, int):
            topology = TopologySpec.chain(graph, topology)
        self.graph = graph
        self.hw = hw
        self.link = link or LinkModel(bandwidth_bytes_per_s=hw.link_bw,
                                      energy_per_bit_j=hw.energy_per_bit_j)
        self.dispatcher = Dispatcher(graph, topology, codecs,
                                     link=self.link, max_batch=max_batch,
                                     admission_depth=admission_depth,
                                     queue_depth=queue_depth,
                                     client_quota=client_quota,
                                     shape_buckets=shape_buckets,
                                     max_batch_cap=max_batch_cap,
                                     replica_factory=replica_factory,
                                     retry_policy=retry_policy,
                                     device=device)
        self.device = self.dispatcher.device
        # the serving-time feedback loop (opt-in): calibrate costs online,
        # repartition / scale behind an epoch fence, adapt batching knobs
        self.controller = (Controller(self.dispatcher, controller)
                           if controller is not None else None)
        self._window_t0 = time.perf_counter()
        self._cpu0 = (time.process_time(), {})

    @property
    def topology(self) -> TopologySpec:
        """The LIVE topology (tracks repartitions and scale events)."""
        return self.dispatcher.topology

    def configure(self, params: dict) -> None:
        self.dispatcher.configure(params)

    def precompile(self) -> None:
        """Warm up all power-of-two batch shapes (apply + codec) before
        serving, so no kernel build or first-call cost lands inside a
        latency window."""
        self.dispatcher.precompile()

    def start(self) -> None:
        self.dispatcher.start()
        if self.controller is not None:
            self.controller.start()
        self._window_t0 = time.perf_counter()
        self._cpu0 = (time.process_time(), thread_cpu_s(self.threads()))

    def threads(self) -> list:
        """The threads the chain runs on in this process (the
        dispatcher's and the controller's)."""
        out = self.dispatcher.threads()
        if self.controller is not None and self.controller.thread:
            out.append(self.controller.thread)
        return out

    # -- spans -----------------------------------------------------------------
    def start_spans(self) -> None:
        """Record the chain's spans from now on (off until called)."""
        self.dispatcher.spans.start()

    def stop_spans(self) -> Spans:
        """Stop recording; hand over the spans recorded since
        :meth:`start_spans`."""
        return self.dispatcher.spans.stop()

    # -- async serving path ---------------------------------------------------
    def submit(self, x: np.ndarray, client_id: Any = 0,
               block: bool = True, timeout: float | None = None,
               priority: int = 0,
               deadline_s: float | None = None) -> Future:
        """Admit one request; backpressure per Dispatcher.submit().
        ``timeout`` bounds admission-queue blocking ONLY; ``deadline_s``
        is the end-to-end result deadline (the future fails with
        :class:`~repro_torch.runtime.dispatcher.DeadlineExceeded` when it
        expires, and late results are dropped).  ``priority`` weights the
        admission dequeue (band weight ``priority + 1``) — see
        :meth:`Dispatcher.submit`."""
        return self.dispatcher.submit(x, client_id=client_id, block=block,
                                      timeout=timeout, priority=priority,
                                      deadline_s=deadline_s)

    def submit_stream(self, inputs: Iterable[np.ndarray], client_id: Any = 0,
                      timeout: float | None = None) -> Iterator[np.ndarray]:
        """Admit a client's stream of INDEPENDENT inputs; yield one result
        per input, in submission order.  (Formerly ``stream()`` — renamed
        so the request-stream sugar cannot be confused with
        :meth:`generate`'s token stream, which yields the TOKENS of one
        autoregressive session.)

        Admission of sample i+1 overlaps compute of sample i — the yield
        order (this client's FIFO) is guaranteed twice over: futures are
        awaited in submission order AND the collector's sequenced merge
        resolves them in that order, replicated stages or not.  With a
        ``timeout``, admission raises :class:`AdmissionFull` instead of
        blocking past it (load shedding).
        """
        pending: list[Future] = []
        for x in inputs:
            pending.append(self.submit(x, client_id=client_id,
                                       timeout=timeout))
        for fut in pending:
            yield fut.result()

    def stream(self, inputs: Iterable[np.ndarray], client_id: Any = 0,
               timeout: float | None = None) -> Iterator[np.ndarray]:
        """Deprecated alias for :meth:`submit_stream` (one result per
        independent input).  For token streaming of one autoregressive
        session, use :meth:`generate`."""
        warnings.warn(
            "InferenceEngine.stream() is now submit_stream() (one result "
            "per independent input); for autoregressive token streaming "
            "use generate()", DeprecationWarning, stacklevel=2)
        return self.submit_stream(inputs, client_id=client_id,
                                  timeout=timeout)

    # -- autoregressive decode serving ----------------------------------------
    def generate(self, prompt, max_new_tokens: int, *,
                 session_id: str | None = None,
                 client_id: Any = None,
                 restart: str = "auto",
                 deadline_s: float | None = None,
                 step_timeout: float | None = 60.0) -> Iterator[int]:
        """Greedy-decode one session through the chain, yielding each token
        as it exits the tail.

        The prompt is prefilled ONCE (per-stage KV caches stay resident on
        the replicas that computed them, routed sticky); each subsequent
        step ships only the newest token per hop.  Loss of residency —
        replica death, drain at a scale fence, repartition, LRU eviction —
        is recovered by re-prefilling the retained history when ``restart``
        permits ('always', or 'auto' with a retry policy set), else the
        iterator raises :class:`~repro_torch.runtime.session.SessionLost`
        (``retryable=False``).  Greedy decode is deterministic, so a
        recovered session's tokens are bit-identical to an undisturbed
        run.  See :func:`repro_torch.runtime.session.generate_tokens`."""
        return generate_tokens(
            self.dispatcher, prompt, max_new_tokens,
            session_id=session_id, client_id=client_id, restart=restart,
            deadline_s=deadline_s, step_timeout=step_timeout)

    # -- elastic membership ----------------------------------------------------
    def scale(self, stage: int, replicas: int,
              timeout: float | None = 60.0,
              precompile: bool = False) -> dict:
        """Grow or drain one stage's replica count on the RUNNING engine.

        Rides the epoch fence: spawn ships the stage's weights to fresh
        replicas and fences them into the routing set; drain fences them
        out, flushes their in-flight work, and retires them.  Zero
        requests are dropped or reordered per client either way.  Returns
        the scale record (see :meth:`Dispatcher.scale`)."""
        return self.dispatcher.scale(stage, replicas, timeout=timeout,
                                     precompile=precompile)

    # -- blocking shim (the original API) ------------------------------------
    def run(self, inputs: Iterable[np.ndarray]) -> tuple[list[np.ndarray], EngineReport]:
        xs = list(inputs)
        self.reset_window()
        t0 = time.perf_counter()
        outs = self.dispatcher.infer_stream(xs)
        wall = time.perf_counter() - t0
        report = self.report(samples=len(xs), wall_s=wall)
        return outs, report

    def shutdown(self, drain: bool = True,
                 timeout: float | None = None) -> None:
        if self.controller is not None:
            self.controller.stop()       # no fence may enter a closing chain
        self.dispatcher.shutdown(drain=drain, timeout=timeout)

    # -- metrics ---------------------------------------------------------------
    def reset_window(self) -> None:
        """Start a fresh measurement window (stats are windowed, not
        lifetime, so long-running servers can report per-interval)."""
        self.dispatcher.reset_stats()
        self._window_t0 = time.perf_counter()
        self._cpu0 = (time.process_time(), thread_cpu_s(self.threads()))

    def report(self, samples: int | None = None,
               wall_s: float | None = None) -> EngineReport:
        d = self.dispatcher
        wall = (wall_s if wall_s is not None
                else time.perf_counter() - self._window_t0)
        # utilization denominators use the measurement-window wall clock
        # (reset_stats -> now): with three overlapping stages per node, any
        # sum-of-busy / load-wall ratio would exceed 1.0 by construction
        util_wall = max(time.perf_counter() - self._window_t0, 1e-9)
        cpu_now = thread_cpu_s(self.threads())
        process_cpu = time.process_time() - self._cpu0[0]
        with d._lock:
            waits = {"admission": d.wait_s["admission"]}
        lat = LatencySummary.from_values(d.latencies)
        n = samples if samples is not None else lat.count
        per_node = []
        bottleneck = 0.0
        total_payload = 0.0
        total_overhead = 0.0
        total_energy = 0.0
        num_nodes = 0
        for group in d.stages:
            stage_service = 0.0
            live = group.live_replicas()
            for node in live:
                num_nodes += 1
                with node._stats_lock:
                    tr = list(node.traces)
                    depths = list(node.queue_depths)
                    busy_dec = node.busy_decode_s
                    busy_cmp = node.busy_compute_s
                    busy_enc = node.busy_encode_s
                counters, node_waits = node.window_report()
                for k, w in node_waits.items():
                    waits[k] = waits.get(k, 0.0) + w
                n_req_raw = sum(t.n for t in tr)
                n_req = n_req_raw or 1
                compute = sum(t.compute_s for t in tr) / n_req
                ser = sum(t.serialize_s for t in tr) / n_req
                des = sum(t.deserialize_s for t in tr) / n_req
                payload = sum(t.payload_bytes for t in tr) / n_req
                chunks = max(1.0, np.ceil(payload / CHUNK_BYTES))
                wire_s = self.link.latency_s * chunks \
                    + payload / self.link.bandwidth_bytes_per_s
                # per-request service time: a replica overlaps decode /
                # compute / encode, so its pipelined bottleneck is the max
                # stage, not the sum (paper: throughput = 1 / max_i service_i)
                service = max(compute, ser, des, wire_s)
                energy = compute_energy_j(compute + ser + des, self.hw) \
                    + network_energy_j(payload, self.hw)
                # replica-aware idle burn: a powered-on replica draws the
                # profile's baseline for every second of the window it is
                # NOT doing work — the cost an over-provisioned stage pays
                # per node that active-energy accounting alone hides.
                # Amortized per inference cycle (the window's request
                # count) so it adds in the same per-cycle units as the
                # active energy above; busy time is capped at the window
                # (three overlapped stage threads can book more than wall
                # on an oversubscribed host).  idle_w defaults to 0, so
                # every pre-replica energy figure is unchanged.
                busy_total = busy_dec + busy_cmp + busy_enc
                idle_energy = idle_energy_j(
                    util_wall - min(busy_total, util_wall),
                    self.hw) / max(1, n)
                per_node.append({
                    "node": node.index, "stage": node.index,
                    "replica": node.replica,
                    "compute_s": compute, "serialize_s": ser,
                    "deserialize_s": des, "wire_s": wire_s,
                    "service_s": service,
                    "payload_bytes": payload, "energy_j": energy,
                    "idle_energy_j": idle_energy,
                    "requests": n_req_raw,
                    # the replica's saturation = its busiest stage's
                    # fraction of the window (stages overlap, so summing
                    # them would let the old total-busy metric exceed 1.0
                    # and get clamped)
                    "utilization": min(1.0, max(busy_dec, busy_cmp, busy_enc)
                                       / util_wall),
                    "util_decode": min(1.0, busy_dec / util_wall),
                    "util_compute": min(1.0, busy_cmp / util_wall),
                    "util_encode": min(1.0, busy_enc / util_wall),
                    # raw (unclamped) busy fractions: can exceed 1.0 on an
                    # oversubscribed host (runnable-but-descheduled time
                    # books as busy) — the controller and BENCH notes read
                    # these to see oversubscription honestly; the clamped
                    # ones above stay for dashboards
                    "util_decode_raw": busy_dec / util_wall,
                    "util_compute_raw": busy_cmp / util_wall,
                    "util_encode_raw": busy_enc / util_wall,
                    "busy_decode_s": busy_dec,
                    "busy_compute_s": busy_cmp,
                    "busy_encode_s": busy_enc,
                    "max_batch": node.max_batch,
                    "coalesce_s": node.coalesce_s,
                    "layers": [ln.name for ln in node._nodes],
                    "queue_depth_mean": (float(np.mean(depths)) if depths
                                         else 0.0),
                    "queue_depth_max": max(depths) if depths else 0,
                    "batch_mean": (float(np.mean([t.n for t in tr])) if tr
                                   else 0.0),
                    **counters,
                })
                stage_service = max(stage_service, service)
                total_payload += payload
                total_overhead += ser + des
                # per-CYCLE units: a replica's energy_j is per request IT
                # processed, and a replicated stage's replicas each see
                # only a share of the window's cycles — weight by that
                # share so the chain total prices each cycle's work once
                # (a 1-replica stage sees every request: share = 1,
                # figures unchanged).  idle_energy is already per cycle.
                total_energy += energy * (n_req_raw / max(1, n)) \
                    + idle_energy
            # a replicated stage's contribution to the modeled pipeline
            # bottleneck amortizes by its replica count (rate, not latency)
            bottleneck = max(bottleneck,
                             stage_service / max(1, len(live)))
        with d._lock:
            waits["result"] = d.wait_s["result"]
        return EngineReport(
            model=d.graph.name,
            num_nodes=num_nodes,
            codec=d.codecs.data.label,
            samples=n,
            wall_s=wall,
            throughput_cps=n / wall if wall > 0 else 0.0,
            modeled_throughput_cps=(1.0 / bottleneck if bottleneck > 0
                                    else 0.0),
            per_node_energy_j=total_energy / max(1, num_nodes),
            overhead_s=total_overhead,
            payload_mb=total_payload / 1e6,
            p50_latency_s=lat.p50_s,
            p99_latency_s=lat.p99_s,
            per_node=per_node,
            cuts=tuple(d.partition.cuts),
            replicas=d.replicas,
            epoch=d.epoch,
            thread_cpu_s=window_cpu_s(self._cpu0[1], cpu_now),
            process_cpu_s=process_cpu,
            step_wait_s=waits,
        )
