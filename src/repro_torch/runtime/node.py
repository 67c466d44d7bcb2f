"""A DEFER compute node (paper Algorithm 2) as a 3-stage internal pipeline.

Each node is one REPLICA of one topology stage: it owns an incoming FIFO
channel (its listening socket — a :class:`~repro_torch.runtime.transport.Channel`
from the stage's transport binding), a reference to the next stage's input
channel (its outgoing socket), and — after the configuration step — a
materialized model partition.  Replicas of the same stage are identical;
the stage's router spreads work across them and this node neither knows
nor cares whether it has siblings.  The paper's
THREAD-1/THREAD-2 pair is generalized into three stages connected by
depth-2 bounded queues (double buffering), so codec work overlaps compute:

    inbox -> [ingress: decode]
          -> _to_compute -> [compute: merge/bucket/stack/apply]
          -> _to_encode  -> [egress: encode ONCE per bucket, relay]
          -> next node's inbox

While batch N runs the partition apply, batch N+1 is deserializing
on the ingress thread and batch N-1 is serializing on the egress thread.
Continuous batching happens at the compute stage: up to ``max_batch``
requests' worth of decoded payloads are merged per step, bucketed by
activation signature (trailing dims + dtype — row counts may be ragged),
concatenated, padded to a power-of-two row count, and computed in ONE
partition apply.  The egress stage then encodes each bucket's stacked
output ONCE — batch-level wire encoding with row-extent framing in the
:class:`BatchEnvelope` — instead of one codec pass per request, so fixed
codec cost amortizes across the batch and the next hop decodes once.

Failure isolation: an exception in any stage's decode/apply/encode is
caught per batch; the affected requests' extents travel on as an ``error``
envelope (formatted traceback) that downstream stages relay untouched, the
collector fails exactly those futures, and the node keeps serving
subsequent batches.

The partition runs eagerly under ``torch.inference_mode()`` on the node's
``torch.device``; weights are turned into device tensors once, when the
node adopts them (configure or reconfig), not on every call.

Timings are recorded per batch (``BatchTrace``) and per stage
(``busy_decode_s`` / ``busy_compute_s`` / ``busy_encode_s``), so the engine
can report the paper's metrics (compute, overhead, payload) plus the
serving ones (per-stage utilization, queue depth, batch occupancy) from
*real* execution — and so the codec/compute overlap is directly measurable.
The decode counters over the window (a step's phases, its steps by how they
ran, :mod:`repro_torch.runtime.step_graph`, the cache pool's fills, the
steps' queue waits, the prefills, the holds) are one :class:`Window`, read
out by :meth:`ComputeNode.window_report`; with the dispatcher's span log
on, the same readings become spans (:mod:`repro_torch.runtime.spans`).

A wave of decode steps may HOLD before it runs: where a resident session
of its bank is due (``StepStaging.due``: it stepped here with the wave's
sessions, or before them, or just behind them, so its next step is on its
way), the compute stage keeps taking arrivals into the wave until every
due session has joined, the wave is full, a frame other than a step
arrives, or the replica's recent step time (``StepTimes``) has passed.  A
replicated stage splits the sessions that stepped together before it;
the hold lets the next stage step them together again, so a step's fixed
rows serve more sessions.
"""
from __future__ import annotations

import dataclasses
import functools
import queue
import threading
import time
import traceback
from typing import Any

import numpy as np
import torch

from repro_torch.core.graph import LayerGraph, LayerNode, tree_bytes
from repro_torch.device import get_device
from repro_torch.runtime.session import SessionStore
from repro_torch.runtime.spans import WORK, SpanLog, waited
from repro_torch.runtime.step_graph import (CAPTURED, EAGER, FAILED, REPLAY,
                                            Slot, StepStaging, StepTimes,
                                            signature)
from repro_torch.runtime.transport import Channel, ChannelClosed, InprocChannel
# _STOP / _RETIRE live in wire.py so the byte framing can map them to
# dedicated frame types (a socket transport must carry them too); they are
# re-exported here because the runtime modules treat this as their home.
# _RETIRE drains ONE replica out of a stage without touching the rest of
# the chain: it flows through the replica's internal stages like _STOP —
# so everything already in its queues completes and relays — but the
# egress exits WITHOUT forwarding it downstream, so the next stage's
# _STOP accounting never sees a retired replica.
from repro_torch.runtime.wire import (_RETIRE, _STOP,  # noqa: F401
                                      K_CLOSE, K_OPEN, K_PLAIN, K_STEP,
                                      BatchEnvelope,
                                      ReconfigMarker, RowExtent, WireCodec,
                                      WireRecord, tree_unflatten_paths)


@dataclasses.dataclass
class BatchTrace:
    """Timings for one merged batch (n requests computed together)."""

    node: int
    n: int                       # requests in the batch
    padded: int                  # rows actually computed (after padding)
    deserialize_s: float         # summed over the batch's inbound envelopes
    compute_s: float             # apply over the stacked buckets
    serialize_s: float           # summed over the batch's outbound encodes
    payload_bytes: int           # summed outbound wire bytes
    encodes: int = 0             # outbound codec passes (== buckets, not n)


@dataclasses.dataclass
class _Decoded:
    """Ingress -> compute: one inbound envelope, decoded once."""

    extents: list[RowExtent]
    boundary: dict[str, np.ndarray]      # stacked over the envelope's extents
    deserialize_s: float
    t_put: float = 0.0                   # put on _to_compute (perf_counter)


@dataclasses.dataclass
class _Computed:
    """Compute -> egress: one merged batch's bucket outputs + its trace."""

    buckets: list[tuple[list[RowExtent], dict[str, np.ndarray]]]
    trace: BatchTrace
    t_put: float = 0.0                   # put on _to_encode (perf_counter)


# a decode step's phases, in order (ComputeNode._step_wave): its tokens,
# positions and live rows copied in, the apply, its output copied out, the
# output split by session
STEP_PHASES = ("stack", "launch", "sync", "unstack")
# a replica's decode steps by how they ran: replayed as its CUDA graph, run
# eagerly (captures included), graphs captured, captures that raised; its
# cache pool's banks allocated and prefills copied into a slot; the live
# rows and all rows its steps ran; the waves that held for due residents
# and the steps that joined them while they held
STEP_COUNTS = ("step_graph_replays", "step_eager_steps",
               "step_graph_captures", "step_graph_failures",
               "pool_banks", "pool_fills", "step_live_rows", "step_rows_run",
               "step_holds", "step_hold_joins")
_COUNTED = {REPLAY: ("step_graph_replays",),
            EAGER: ("step_eager_steps",),
            CAPTURED: ("step_eager_steps", "step_graph_captures"),
            FAILED: ("step_eager_steps", "step_graph_failures")}
# a replica's queues, each closed by the take of the thread it feeds
QUEUES = ("inbox", "to_compute", "to_encode")


@dataclasses.dataclass
class _Hold:
    """A wave of decode steps held for the due residents of its banks
    (``ComputeNode._hold``): from ``t0`` until ``deadline`` at most."""

    t0: float
    deadline: float
    due: set                    # (bank, row) of the due slots not yet in
    joins: int = 0              # steps taken into the wave while it held
    timed_out: bool = False


@dataclasses.dataclass
class Window:
    """A replica's decode counters over the measurement window: the decode
    steps' phases and the waves' holds (s), their counts (``STEP_COUNTS``)
    and their waits in each queue (s times steps); the session opens'
    prefills (s, as their spans, and prompt tokens); and the replica's
    device tallies as read at the window's start.  ``ComputeNode.reset_stats``
    replaces it whole and ``ComputeNode.window_report`` reads it out, so a
    new counter is a field here and an entry there."""

    step_s: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys((*STEP_PHASES, "hold"), 0.0))
    step_counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(STEP_COUNTS, 0))
    wait_s: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(QUEUES, 0.0))
    prefill_s: float = 0.0
    prefill_tokens: int = 0
    tallies0: dict[tuple[str, str], torch.Tensor] = dataclasses.field(
        default_factory=dict)


def _bucket_rows(n: int) -> int:
    """Next power of two >= n: bounds the batch shapes per signature."""
    p = 1
    while p < n:
        p *= 2
    return p


def _signature(boundary: dict[str, np.ndarray]) -> tuple:
    """Bucket key: leaf names + trailing dims + dtypes.  Row counts are
    free to differ — ragged requests concatenate along axis 0."""
    return tuple(sorted((k, v.shape[1:], str(v.dtype))
                        for k, v in boundary.items()))


def _pad_middle(arr: np.ndarray) -> np.ndarray:
    """Zero-pad every middle axis up to the next power of two (no-op for
    rank <= 2 or already-pow2 sizes)."""
    if arr.ndim <= 2:
        return arr
    pads = [(0, 0)] + [(0, _bucket_rows(s) - s) for s in arr.shape[1:-1]] \
        + [(0, 0)]
    if all(p == (0, 0) for p in pads):
        return arr
    return np.pad(arr, pads)


class ComputeNode:
    """One compute node in the chain."""

    def __init__(self, index: int, data_codec: WireCodec,
                 queue_depth: int = 8, max_batch: int = 8,
                 coalesce_s: float = 0.005,
                 shape_buckets: str = "exact",
                 max_batch_cap: int | None = None,
                 replica: int = 0,
                 inbox: Channel | None = None,
                 session_capacity: int = 64,
                 device: str | torch.device | None = None,
                 spans: SpanLog | None = None):
        self.index = index              # stage index (ReconfigMarker plans
        self.replica = replica          # are keyed by it); replica id within
        self.data_codec = data_codec    # the stage
        self.device = get_device(device)
        # max_batch and coalesce_s are ADAPTIVE knobs: the serving
        # controller retunes them online from the measured codec/compute
        # stage-time ratio (plain attribute writes; each wave re-reads them)
        self.max_batch = max(1, max_batch)
        self.coalesce_s = coalesce_s
        # "pow2": near-miss trailing shapes merge into one apply via
        # bucketed pad-to-shape (opt-in: requires layers that preserve and
        # act independently along the padded middle axes)
        assert shape_buckets in ("exact", "pow2")
        self.shape_buckets = shape_buckets
        # ceiling for the controller's adaptive max_batch growth;
        # precompile() traces up to the cap so growth never compiles
        # inside a serving window
        self.max_batch_cap = max(self.max_batch, max_batch_cap or 0)
        self.epoch = 0              # last ReconfigMarker this node committed
        self.retiring = False       # drained by scale(), flushing until the
                                    # fence + retire token clear its queues
        self.inbox: Channel = inbox if inbox is not None \
            else InprocChannel(queue_depth)
        self.next_inbox: Channel | None = None
        self._egress_epoch = 0      # epoch stamp for outbound envelopes
        # depth 2 between the stage threads: double buffering
        self._to_compute: queue.Queue = queue.Queue(maxsize=2)
        self._to_encode: queue.Queue = queue.Queue(maxsize=2)
        # an item popped for a wave/merge that would overflow max_batch is
        # stashed here and leads the next wave (queues can't push back)
        self._ingress_pending = None
        self._compute_pending = None
        self.traces: list[BatchTrace] = []
        self.queue_depths: list[int] = []
        # running totals over the window (kept alongside the trace list so
        # the controller's periodic snapshot() is O(1), not O(waves))
        self._depth_sum = 0
        self._depth_count = 0
        self._trace_n = 0
        self._trace_compute_s = 0.0
        self._trace_serialize_s = 0.0
        self._trace_deserialize_s = 0.0
        self._trace_payload_bytes = 0
        self._trace_encodes = 0
        self.busy_decode_s: float = 0.0
        self.busy_compute_s: float = 0.0
        self.busy_encode_s: float = 0.0
        self.window = Window()
        # device counters the decode steps' layers add into, by name and
        # layer (a routed-expert block's moe_rows and moe_dropped; see
        # repro_torch.models.moe.held_experts_step), for the replica's life
        self.step_tallies: dict[str, dict[str, torch.Tensor]] = {}
        # the dispatcher's span log (its own, off, for a node built alone)
        self.spans = spans if spans is not None else SpanLog()
        s = f"defer.s{index}"
        self._span_names = {k: f"{s}.{k}" for k in (
            "decode", "wave", "compute", "prefill", "encode", "relay",
            *(f"step.{p}" for p in (*STEP_PHASES, "hold")))}
        self._span_names.update({q: f"defer.wait.s{index}.{q}"
                                 for q in QUEUES})
        self.config_records: list[WireRecord] = []
        self._graph: LayerGraph | None = None
        self._nodes: list[LayerNode] = []
        self._pad_safe = True
        self._params: dict | None = None
        self._required: list[str] = []
        self._exported: list[str] = []
        self._apply = None
        # decode-session state: each session pinned to this replica holds a
        # slot of its cache pool (LRU-bounded — see SessionStore); prefill/
        # step views built only when the graph is decode-capable
        self.sessions = SessionStore(session_capacity)
        self._prefill_apply = None
        self._decode_apply = None
        self._step_rows = 1
        # the cache pool: banks of the decode step's buffers (each with its
        # CUDA graph), one more when every slot is held; emptied by each
        # _make_apply; compute thread only
        self._banks: list[StepStaging] = []
        # the pool's recent step times, which bound a wave's hold
        self.step_times = StepTimes()
        self._is_tail = False
        self._threads: list[threading.Thread] = []
        self._stats_lock = threading.Lock()
        # live gauge (NOT a window counter — reset_stats leaves it):
        # requests consumed off the inbox but not yet emitted downstream.
        # A wedged compute thread that swallowed its whole backlog shows
        # inbox qsize 0 (credits returned on consume), so stall detection
        # needs this to see work trapped inside the pipeline.
        self._inflight_n = 0

    # -- configuration step (paper §III-B) ----------------------------------
    def configure(self, graph: LayerGraph, lo: int, hi: int,
                  arch_blob: bytes, weights_blob: bytes,
                  weights_codec: WireCodec) -> None:
        """Receive architecture + weights over the wire and build the model.

        ``graph`` supplies only the layer *functions* (code is pre-installed
        on nodes, as in the paper — TF/Keras is on every device); topology
        and weights come from the wire blobs.
        """
        t0 = time.perf_counter()
        import json
        spec = json.loads(arch_blob.decode())
        flat, dec_s = weights_codec.decode_tree(weights_blob)
        nested = tree_unflatten_paths(flat)
        t1 = time.perf_counter()
        self.config_records.append(
            WireRecord("architecture", len(arch_blob), len(arch_blob), 0.0, 0.0))
        self.config_records.append(
            WireRecord("weights", sum(a.nbytes for a in flat.values()),
                       len(weights_blob), 0.0, t1 - t0))
        self._graph = graph
        self._set_range(lo, hi)
        assert [n.name for n in self._nodes] == spec["layers"], \
            "wire architecture disagrees with local layer code"
        self._params = self._graph.prepare(nested, self.device, self._nodes)
        self._make_apply()

    def _set_range(self, lo: int, hi: int) -> None:
        """Adopt layer range [lo, hi): chain semantics say inbound wire =
        everything crossing the cut before this stage; outbound = everything
        crossing the cut after (includes pass-through activations this
        stage merely relays)."""
        graph = self._graph
        self._nodes = graph.slice_nodes(lo, hi)
        self._required = graph.crossing_names(lo - 1) if lo > 0 else [""]
        self._exported = (graph.crossing_names(hi - 1) if hi < len(graph.nodes)
                          else [graph.nodes[-1].name])
        # pow2 pad-to-shape assumes every layer in the slice preserves and
        # acts independently along padded middle axes; a single pad-unsafe
        # layer (attention over the padded axis) makes this segment fall
        # back to exact bucketing
        self._pad_safe = all(n.pad_safe for n in self._nodes)
        # the tail stage trims decode outputs to the last position, so a
        # session frame ships one row of logits, not the whole prompt's
        self._is_tail = hi == len(graph.nodes)

    def _apply_reconfig(self, marker: ReconfigMarker) -> None:
        """Commit a live repartition at the epoch fence (compute stage).

        Runs on the compute thread exactly when the marker passes it, so
        every envelope ahead of the marker was computed with the old
        partition and every one behind it gets the new — no request sees a
        mixed chain.  Weights arrive as a DIFF: only layers this node
        gains were shipped; layers it keeps are reused in place, layers it
        loses are dropped."""
        plan = marker.plans.get(self.index)
        self.epoch = marker.epoch
        if plan is None:                 # this node's range did not change
            return
        import json
        t0 = time.perf_counter()
        spec = json.loads(plan.arch_blob.decode())
        params = {name: self._params[name] for name in spec["layers"]
                  if name in self._params}
        self._set_range(plan.lo, plan.hi)
        if plan.weights_blob:
            # the codec may have crossed a wire, which does not carry the
            # device: decode on this node's own
            codec = dataclasses.replace(plan.weights_codec, device=self.device)
            flat, _ = codec.decode_tree(plan.weights_blob)
            params.update(self._graph.prepare(tree_unflatten_paths(flat),
                                              self.device, self._nodes))
        assert [n.name for n in self._nodes] == spec["layers"], \
            "wire architecture disagrees with local layer code"
        # param-less layers (pool / add / activation nodes) legitimately
        # have no wire entry — only parameterized layers must have arrived
        missing = [n.name for n in self._nodes if n.name not in params
                   and n.param_bytes]
        assert not missing, f"reconfig weights diff is missing {missing}"
        self._params = params
        # the layer slice moved: _make_apply drops every resident session.
        # The dispatcher displaces every active session at the same fence,
        # so their generate loops re-prefill instead of stepping into
        # SessionLost.
        self._make_apply()
        self.config_records.append(WireRecord(
            "reconfig", tree_bytes(params),
            plan.wire_bytes, 0.0, time.perf_counter() - t0))

    def _make_apply(self):
        nodes, params = self._nodes, self._params
        exported = self._exported

        def apply_fn(boundary: dict[str, Any]) -> dict[str, Any]:
            acts = dict(boundary)
            with torch.inference_mode():
                for node in nodes:
                    args = [acts[i] for i in node.inputs]
                    acts[node.name] = node.fn(params.get(node.name, {}), *args)
            return {n: acts[n] for n in exported}

        self._apply = apply_fn

        # autoregressive view of the same slice: prefill walks the chain
        # once over a full prompt collecting each stateful layer's KV
        # cache; step consumes one token per row against a bank's caches
        # (rows may sit at different sequence positions).  Only built for
        # decode-capable graphs — a pure chain, so the slice has exactly
        # one inbound and one outbound boundary activation.
        self._prefill_apply = None
        self._decode_apply = None
        # new params or layers: every resident cache is keyed to the old
        # ones and is now meaningless, and a graph over them must never
        # replay — the sessions and the pool go
        self.sessions.clear()
        self._banks = []
        self.step_times = StepTimes()
        graph = self._graph
        if (graph is None or not graph.decode_capable or not nodes
                or len(self._required) != 1 or len(exported) != 1):
            return

        def prefill_fn(x: torch.Tensor):
            acts = x
            caches = {}
            with torch.inference_mode():
                for node in nodes:
                    p = params.get(node.name, {})
                    if node.decode is not None:
                        acts, caches[node.name] = node.decode.prefill_fn(
                            p, acts)
                    else:
                        acts = node.fn(p, acts)
            return acts, caches

        def step_fn(caches, x: torch.Tensor, pos: torch.Tensor):
            acts = x
            new = {}
            with torch.inference_mode():
                for node in nodes:
                    p = params.get(node.name, {})
                    if node.decode is not None:
                        acts, new[node.name] = node.decode.step_fn(
                            p, caches[node.name], acts, pos)
                    else:
                        acts = node.fn(p, acts)
            return acts, new

        self._prefill_apply = prefill_fn
        self._decode_apply = step_fn
        # rows of every step apply: the graph's, at which its reference
        # decodes too (see repro_torch.models.lm_graph)
        self._step_rows = graph.decode_step_rows

    def precompile(self) -> None:
        """Warm up every power-of-two padded batch shape this node can hit
        under continuous batching — the stacked apply AND the data codec
        (q8's kernel build and its shapes) — so serving never pays a
        kernel build, an algorithm search or an allocator growth inside a
        measurement window.

        Serving pads bucket totals with ``_bucket_rows`` (pow2 over the
        summed rows), so the traced shapes are ``_bucket_rows(r * base)``
        for every request count r up to max_batch — not r-fold tilings,
        which would miss the padded shapes whenever ``base`` is not itself
        a power of two."""
        if self._apply is None or self._graph is None:
            return
        base: dict[str, np.ndarray] = {}
        for name in self._required:
            spec = (self._graph.input_spec if name == ""
                    else self._graph[name].out_spec)
            base[name] = np.zeros(spec.shape, np.dtype(spec.dtype))
        base_rows = next(iter(base.values())).shape[0]
        r = 1
        while r <= self.max_batch_cap:
            target = _bucket_rows(r * base_rows)
            r *= 2
            reps = -(-target // base_rows)
            boundary = {k: torch.from_numpy(
                np.concatenate([v] * reps, axis=0)[:target] if reps > 1
                else v[:target]).to(self.device)
                for k, v in base.items()}
            outs = self._apply(boundary)
            outs = {k: v.cpu().numpy() for k, v in outs.items()}
            blob, _ = self.data_codec.encode_tree(outs, "data")
            self.data_codec.decode_tree(blob)

    # -- inference step (paper §III-C) ----------------------------------------
    def start(self) -> None:
        if any(t.is_alive() for t in self._threads):
            return
        name = f"defer-s{self.index}r{self.replica}"
        self._threads = [
            threading.Thread(target=self._ingress_loop, daemon=True,
                             name=f"{name}-ingress"),
            threading.Thread(target=self._compute_loop, daemon=True,
                             name=f"{name}-compute"),
            threading.Thread(target=self._exit_clearing(self._egress_loop),
                             daemon=True, name=f"{name}-egress"),
        ]
        for t in self._threads:
            t.start()

    def _exit_clearing(self, loop):
        """Wrap a replica's final pipeline stage so its exit — stop,
        retire, drain, or a dead link — releases the resident KV caches:
        an exited replica serves no further steps, and session recovery
        is re-prefill elsewhere, so the memory must not linger."""
        def run():
            try:
                loop()
            finally:
                self.sessions.clear()
                self._banks = []
        return run

    def stop(self) -> None:
        self.inbox.send(_STOP)
        self.join()

    def retire(self) -> None:
        """Queue the single-replica drain token (see ``_RETIRE``).  The
        caller fences routing first; everything already in this replica's
        queues still completes and relays before the threads exit."""
        self.inbox.send(_RETIRE)

    def join(self) -> None:
        for t in self._threads:
            t.join()

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.traces = []
            self.queue_depths = []
            self._depth_sum = 0
            self._depth_count = 0
            self._trace_n = 0
            self._trace_compute_s = 0.0
            self._trace_serialize_s = 0.0
            self._trace_deserialize_s = 0.0
            self._trace_payload_bytes = 0
            self._trace_encodes = 0
            self.busy_decode_s = 0.0
            self.busy_compute_s = 0.0
            self.busy_encode_s = 0.0
            self.window = Window(tallies0={
                (c, k): t.clone() for c, by in list(self.step_tallies.items())
                for k, t in list(by.items())})

    def window_report(self) -> tuple[dict[str, Any], dict[str, float]]:
        """This replica's decode counters over the window (:class:`Window`)
        as the engine report's entries for it: ``step_{phase}_s``,
        ``step_hold_s`` (the waves' holds, wall s), each of
        ``STEP_COUNTS``, ``prefill_s``, ``prefill_tokens`` and each device
        tally's additions since the window's start, by layer (a read from
        the device: never inside a window); and its decode steps' waits by
        queue, keyed ``s{stage}.{queue}``."""
        with self._stats_lock:
            w = self.window
            entries = {**{f"step_{p}_s": v for p, v in w.step_s.items()},
                       **w.step_counts, "prefill_s": w.prefill_s,
                       "prefill_tokens": w.prefill_tokens}
            waits = {f"s{self.index}.{q}": v for q, v in w.wait_s.items()}
        base = w.tallies0
        entries.update({
            c: {k: (t - base[c, k] if (c, k) in base else t).tolist()
                for k, t in list(by.items())}
            for c, by in list(self.step_tallies.items())})
        return entries, waits

    def _waited(self, queue_name: str, t_put: float, extents) -> float:
        """Close the wait of an item this replica's thread just took off
        ``queue_name`` (see :func:`repro_torch.runtime.spans.waited`)."""
        return waited(self.spans, self._span_names[queue_name], t_put,
                      extents, self.index, self.replica)

    def _span(self, name: str, t0: float, t1: float, extents) -> None:
        """Record one work span of this replica (log on only)."""
        self.spans.add(self._span_names[name], t0, t1, WORK, extents,
                       self.index, self.replica)

    def _record_trace(self, trace: BatchTrace) -> None:
        """Append a finished batch's trace and fold it into the running
        totals.  Caller must hold ``_stats_lock``."""
        self.traces.append(trace)
        self._trace_n += trace.n
        self._trace_compute_s += trace.compute_s
        self._trace_serialize_s += trace.serialize_s
        self._trace_deserialize_s += trace.deserialize_s
        self._trace_payload_bytes += trace.payload_bytes
        self._trace_encodes += trace.encodes

    def snapshot(self) -> dict:
        """One consistent view of the current measurement window's
        telemetry — what the serving controller calibrates costs and
        adapts knobs from.  All time fields are window totals; ``n`` is
        requests computed this window.  O(1): reads the running totals,
        not the trace list."""
        with self._stats_lock:
            waves = len(self.traces)
            return {
                "node": self.index,
                "replica": self.replica,
                "n": self._trace_n,
                "compute_s": self._trace_compute_s,
                "serialize_s": self._trace_serialize_s,
                "deserialize_s": self._trace_deserialize_s,
                "payload_bytes": self._trace_payload_bytes,
                "encodes": self._trace_encodes,
                "busy_decode_s": self.busy_decode_s,
                "busy_compute_s": self.busy_compute_s,
                "busy_encode_s": self.busy_encode_s,
                "queue_depth_mean": (self._depth_sum / self._depth_count
                                     if self._depth_count else 0.0),
                "batch_mean": (self._trace_n / waves if waves else 0.0),
                # raw accumulators, so a delta-ing consumer (the
                # controller) can rebuild per-interval means instead of
                # mixing interval counters with window-cumulative gauges
                "waves": waves,
                "depth_sum": self._depth_sum,
                "depth_count": self._depth_count,
                "max_batch": self.max_batch,
                "coalesce_s": self.coalesce_s,
                "epoch": self.epoch,
                "inflight_n": self._inflight_n,
            }

    # -- stage 1: ingress (decode) --------------------------------------------
    def _ingress_loop(self) -> None:
        """Drain whatever is already queued (up to max_batch requests),
        decode each envelope once, and hand the whole wave to the compute
        stage — batches form *before* the slow decode, exactly where the
        backlog accumulates, so one wave becomes one apply and one encode."""
        while True:
            waits = 0.0                 # decode steps' inbox wait (s)
            env = self._ingress_pending
            self._ingress_pending = None
            if env is None:
                try:
                    env = self.inbox.recv()
                except ChannelClosed:
                    # the inbound link died (socket reset / killed): this
                    # replica can never receive again, so it retires —
                    # everything already decoded flushes, nothing is
                    # signaled downstream (the router proxies its control
                    # tokens), and shutdown can still join its threads
                    self.retiring = True
                    self._to_compute.put(_RETIRE)
                    return
                if isinstance(env, BatchEnvelope):
                    waits += self._waited("inbox", env.t_put, env.extents)
            if env is _STOP or env is _RETIRE:
                self._to_compute.put(env)
                return
            if isinstance(env, ReconfigMarker):
                # the epoch fence rides the FIFO: decode is partition-
                # independent, so ingress just relays it in order
                self._to_compute.put(env)
                continue
            wave = [env]
            n_parts = env.n if env.error is None else 0
            saw_stop = None
            deadline = None
            while n_parts < self.max_batch:
                try:
                    nxt = self.inbox.recv_nowait()
                except queue.Empty:
                    # downstream still chewing on the previous wave: a
                    # bounded coalescing window grows this wave instead of
                    # queueing a tiny one behind it (bigger waves = fewer
                    # codec passes; compute is busy so latency cost ~ 0)
                    if self._to_compute.qsize() == 0:
                        break
                    now = time.perf_counter()
                    if deadline is None:
                        deadline = now + self.coalesce_s
                    if now >= deadline:
                        break
                    try:
                        nxt = self.inbox.recv(timeout=deadline - now)
                    except queue.Empty:
                        continue
                    except ChannelClosed:
                        self.retiring = True
                        saw_stop = _RETIRE      # flush this wave, then exit
                        break
                except ChannelClosed:
                    self.retiring = True
                    saw_stop = _RETIRE
                    break
                if nxt is _STOP or nxt is _RETIRE:
                    saw_stop = nxt
                    break
                if isinstance(nxt, ReconfigMarker):
                    # close the wave at the fence; the marker leads the
                    # next iteration so it stays ordered behind this wave
                    self._ingress_pending = nxt
                    break
                waits += self._waited("inbox", nxt.t_put, nxt.extents)
                if nxt.error is None and n_parts + nxt.n > self.max_batch:
                    # would overflow the batch contract (and the pow2
                    # specializations precompile() traced): next wave's
                    self._ingress_pending = nxt
                    break
                wave.append(nxt)
                if nxt.error is None:
                    n_parts += nxt.n
            # book only codec time as decode busy — the queue puts below can
            # block on backpressure, which is waiting, not stage work
            des_busy = 0.0
            decoded: list[_Decoded] = []
            relay: list[BatchEnvelope] = []
            first = None
            for env in wave:
                if env.error is not None:       # relay failures untouched
                    relay.append(env)
                    continue
                t1 = time.perf_counter()
                first = t1 if first is None else first
                try:
                    flat, _ = self.data_codec.decode_tree(env.blob)
                    t2 = time.perf_counter()
                    decoded.append(_Decoded(
                        env.extents,
                        {k: np.asarray(v) for k, v in flat.items()}, t2 - t1))
                except Exception:
                    t2 = time.perf_counter()
                    relay.append(BatchEnvelope(
                        env.extents, b"", error=traceback.format_exc()))
                des_busy += t2 - t1
            if self.spans.on and first is not None:
                self._span("decode", first, t2,
                           [e for env in wave for e in env.extents])
            with self._stats_lock:
                self.busy_decode_s += des_busy
                self.window.wait_s["inbox"] += waits
                self._inflight_n += sum(len(e.extents) for e in wave)
            for env in relay:
                self._to_compute.put(env)
            if decoded:
                t_put = time.perf_counter()
                for d in decoded:
                    d.t_put = t_put
                self._to_compute.put(decoded)
            if saw_stop is not None:
                self._to_compute.put(saw_stop)
                return

    # -- stage 2: compute (merge, bucket, stack, apply) -----------------------
    def _compute_loop(self) -> None:
        while True:
            item = self._compute_pending
            self._compute_pending = None
            if item is None:
                item = self._to_compute.get()
            if item is _STOP or item is _RETIRE:
                self._to_encode.put(item)
                return
            if isinstance(item, ReconfigMarker):
                # the fence reached the compute stage: swap partitions NOW
                # (everything ahead of it already computed on the old one)
                self._apply_reconfig(item)
                self._to_encode.put(item)
                continue
            if isinstance(item, BatchEnvelope):  # error passthrough
                self._to_encode.put(item)
                continue
            waits = self._waited("to_compute", item[0].t_put,
                                 [e for d in item for e in d.extents])
            # continuous batching, second chance: merge any further decoded
            # waves, up to max_batch requests, that are already queued;
            # then, where a wave of steps has due residents, hold for them
            group = list(item)
            n_parts = sum(len(d.extents) for d in group)
            saw_stop = None
            hold = None
            while n_parts < self.max_batch:
                try:
                    if hold is None:
                        nxt = self._to_compute.get_nowait()
                    else:
                        # blocks: the stages' threads share the GIL
                        nxt = self._to_compute.get(timeout=max(
                            0.0, hold.deadline - time.perf_counter()))
                except queue.Empty:
                    if hold is not None:
                        hold.timed_out = True
                        break
                    hold = self._hold(group)
                    if hold is None:
                        break
                    continue
                if nxt is _STOP or nxt is _RETIRE:
                    saw_stop = nxt
                    break
                if isinstance(nxt, ReconfigMarker):
                    self._compute_pending = nxt    # fence: no merging across
                    break
                if isinstance(nxt, BatchEnvelope):
                    self._to_encode.put(nxt)
                    continue
                waits += self._waited("to_compute", nxt[0].t_put,
                                      [e for d in nxt for e in d.extents])
                add = sum(len(d.extents) for d in nxt)
                if n_parts + add > self.max_batch:
                    self._compute_pending = nxt     # next merge's
                    break
                group.extend(nxt)
                n_parts += add
                if hold is not None:
                    # a frame other than a step is served now
                    slots = self._slots(nxt)
                    if slots is None:
                        break
                    hold.joins += len(nxt)
                    hold.due.difference_update(slots)
                    if not hold.due:
                        break
            t_held = time.perf_counter()
            if hold is not None and hold.timed_out:
                for bank, row in hold.due:
                    bank.late[row] = True
            depth = n_parts + self.inbox.qsize() + self._to_compute.qsize()
            with self._stats_lock:
                self.queue_depths.append(depth)
                self._depth_sum += depth
                self._depth_count += 1
                self.window.wait_s["to_compute"] += waits
                if hold is not None:
                    self.window.step_s["hold"] += t_held - hold.t0
                    self.window.step_counts["step_holds"] += 1
                    self.window.step_counts["step_hold_joins"] += hold.joins
            if self.spans.on and hold is not None:
                self._span("step.hold", hold.t0, t_held,
                           [e for d in group for e in d.extents])
            t0 = time.perf_counter()
            out, failures = self._compute_group(group)
            t1 = time.perf_counter()
            with self._stats_lock:
                self.busy_compute_s += t1 - t0
            if self.spans.on:
                self._span("wave", t0, t1,
                           [e for d in group for e in d.extents])
            for env in failures:
                self._to_encode.put(env)
            if out is not None:
                out.t_put = time.perf_counter()
                self._to_encode.put(out)
            if saw_stop is not None:
                self._to_encode.put(saw_stop)
                return

    def _slots(self, frames: list[_Decoded]) -> list[tuple] | None:
        """The (bank, row) of the slot of each step among ``frames`` whose
        session this replica holds; None where a frame is not a session's
        step."""
        if not all(len(d.extents) == 1 and d.extents[0].kind == K_STEP
                   for d in frames):
            return None
        slots = [self.sessions.get(d.extents[0].session) for d in frames]
        return [(s.bank, s.row) for s in slots if s is not None]

    def _hold(self, group: list[_Decoded]) -> _Hold | None:
        """A hold for a wave of ``group``, where it is all steps and some
        bank of its sessions has due residents (``StepStaging.due``, with
        the bound as its slack), bounded by the replica's recent step time;
        None before the replica has stepped (no bound yet), or where
        nothing is due (a lone resident never holds)."""
        bound = self.step_times.bound()
        slots = self._slots(group) if bound is not None else None
        if not slots:
            return None
        rows: dict[StepStaging, list[int]] = {}
        for bank, row in slots:
            rows.setdefault(bank, []).append(row)
        due = {(bank, r) for bank, rs in rows.items()
               for r in bank.due(rs, bound)}
        if not due:
            return None
        t0 = time.perf_counter()
        return _Hold(t0, t0 + bound, due)

    def _pad_to_bucket(self, d: _Decoded) -> _Decoded:
        """Zero-pad a decoded segment's middle axes up to the pow2 bucket
        sizes, recording each extent's ORIGINAL sizes the first time it is
        padded (later hops see already-pow2 shapes, so padding there is a
        no-op and the original trim is preserved).

        One ``pad_trim`` describes every leaf of the request, so a
        boundary whose leaves disagree on middle-axis sizes (e.g. a cut
        crossed by several pass-through activations) is left unpadded —
        it falls back to exact bucketing rather than risking a trim that
        slices real rows off a sibling leaf."""
        mids = {tuple(v.shape[1:-1]) for v in d.boundary.values()
                if v.ndim > 2}
        if len(mids) != 1:
            return d
        padded = {k: _pad_middle(v) for k, v in d.boundary.items()}
        if all(padded[k] is d.boundary[k] for k in padded):
            return d
        orig_mid = next(iter(mids))
        extents = [e if e.pad_trim is not None
                   else dataclasses.replace(e, pad_trim=orig_mid)
                   for e in d.extents]
        return _Decoded(extents, padded, d.deserialize_s)

    def _stack_apply(self, segments: list[dict[str, np.ndarray]],
                     total: int, target: int, extents: list[RowExtent]
                     ) -> tuple[dict[str, np.ndarray], float]:
        """Concatenate per-leaf segments along axis 0, zero-pad to ``target``
        rows, run the partition apply once, trim back to ``total``.

        The timed region ends with the device-to-host copy, which waits for
        the device: without it ``compute_s`` would record launch time only.
        The span (``extents``' ``compute``) covers the stacking too."""
        t_in = time.perf_counter()
        stacked: dict[str, torch.Tensor] = {}
        for key in segments[0]:
            arrs = [s[key] for s in segments]
            cat = np.concatenate(arrs, axis=0) if len(arrs) > 1 else arrs[0]
            if target > total:
                pad = np.zeros((target - total,) + cat.shape[1:], cat.dtype)
                cat = np.concatenate([cat, pad], axis=0)
            stacked[key] = torch.from_numpy(cat).to(self.device)
        t0 = time.perf_counter()
        res = self._apply(stacked)
        res = {k: v.cpu().numpy()[:total] for k, v in res.items()}  # block
        t1 = time.perf_counter()
        if self.spans.on:
            self._span("compute", t_in, t1, extents)
        return res, t1 - t0

    def _compute_group(self, group: list[_Decoded]
                       ) -> tuple[_Computed | None, list[BatchEnvelope]]:
        """Bucket decoded segments by signature, one stacked apply each.

        A bucket whose apply raises becomes an error envelope for exactly
        its own extents; sibling buckets in the merged group still return
        their results.

        With ``shape_buckets='pow2'``, near-miss trailing shapes are first
        zero-padded along their middle axes to the bucket's power-of-two
        sizes, so e.g. ragged sequence lengths merge into ONE apply instead
        of one bucket each; the original sizes ride the extents
        (``pad_trim``) and the tail collector trims them back out."""
        n = sum(len(d.extents) for d in group)
        des_s = sum(d.deserialize_s for d in group)
        # session frames (kind != K_PLAIN) take the decode path; plain
        # traffic keeps the stacked-apply path.  Both run inside the same
        # merged wave, so a chain can serve single-shot and decode traffic
        # simultaneously off one set of replicas.
        plain: list[_Decoded] = []
        sess: list[_Decoded] = []
        for d in group:
            (sess if any(e.kind != K_PLAIN for e in d.extents)
             else plain).append(d)
        outs: list[tuple[list[RowExtent], dict[str, np.ndarray]]] = []
        failures: list[BatchEnvelope] = []
        compute_total = 0.0
        padded_rows = 0
        if sess:
            s_out, s_fail, s_compute, s_padded = self._decode_group(sess)
            outs.extend(s_out)
            failures.extend(s_fail)
            compute_total += s_compute
            padded_rows += s_padded
        if self.shape_buckets == "pow2" and self._pad_safe:
            # only when every layer in this replica's slice is pad_safe:
            # a segment containing e.g. attention over the middle axis
            # would see padded positions, so it stays on exact bucketing
            plain = [self._pad_to_bucket(d) for d in plain]
        buckets: dict[tuple, list[_Decoded]] = {}
        for d in plain:
            buckets.setdefault(_signature(d.boundary), []).append(d)

        for segs in buckets.values():
            extents = [e for d in segs for e in d.extents]
            total = sum(next(iter(d.boundary.values())).shape[0]
                        for d in segs)
            target = _bucket_rows(total)
            padded_rows += target
            try:
                res, apply_s = self._stack_apply(
                    [d.boundary for d in segs], total, target, extents)
            except Exception:
                failures.append(BatchEnvelope(extents, b"",
                                              error=traceback.format_exc()))
                continue
            compute_total += apply_s
            outs.append((extents, res))
        if not outs:
            return None, failures
        trace = BatchTrace(self.index, n, padded_rows, des_s, compute_total,
                           0.0, 0, encodes=0)
        return _Computed(outs, trace), failures

    def _decode_group(self, group: list[_Decoded]
                      ) -> tuple[list, list[BatchEnvelope], float, int]:
        """Serve one merged wave's session traffic (kind != K_PLAIN).

        Closes release the session's slot and pass their payload through
        untouched (each stage on the way to the tail releases in turn).
        Opens run the slice's prefill individually (B=1) and copy the
        resulting caches into a slot of this replica's cache pool, which
        the session holds in its :class:`SessionStore`; the tail stage
        trims its output to the last position so only one row of logits
        ships.  Steps batch ACROSS sessions: the sessions whose slots are
        rows of one bank step in one apply of that bank, in place,
        positions riding per row — continuous batching of decode at
        *different* sequence positions.  Every step apply computes exactly
        ``decode_step_rows`` rows, the rows of sessions not in the wave
        and empty ones too, so a session's arithmetic is the
        single-session reference's whatever shares its bank.  A step whose
        session holds no slot here (evicted, repartitioned, replica
        restarted) fails with a ``SessionLost`` error envelope; recovery is
        the generate loop's re-prefill, never a replay.

        Session envelopes carry exactly one extent by protocol (routers
        pin whole envelopes; a multi-session envelope could not route
        sticky), enforced here.

        Returns ``(outs, failures, compute_s, padded_rows)`` for the
        caller's trace accounting; ``compute_s`` ends with each result's
        device-to-host copy.
        """
        outs: list[tuple[list[RowExtent], dict[str, np.ndarray]]] = []
        failures: list[BatchEnvelope] = []
        compute_s = 0.0
        padded = 0
        out_name = self._exported[0] if self._exported else ""
        steps: list[tuple[RowExtent, np.ndarray]] = []
        for d in group:
            if len(d.extents) != 1:
                failures.append(BatchEnvelope(
                    d.extents, b"",
                    error="decode protocol violation: a session envelope "
                          "must carry exactly one extent"))
                continue
            e = d.extents[0]
            if e.kind == K_CLOSE:
                self.sessions.pop(e.session)
                outs.append(([e], d.boundary))
                continue
            if self._prefill_apply is None:
                failures.append(BatchEnvelope(
                    [e], b"",
                    error="SessionUnsupported: this partition has no "
                          "autoregressive view (the graph declares no "
                          "LayerDecode nodes, or the slice is not a "
                          "single-boundary chain)"))
                continue
            x = next(iter(d.boundary.values()))
            if e.kind == K_OPEN:
                t0 = time.perf_counter()
                try:
                    y, caches = self._prefill_apply(
                        torch.from_numpy(x).to(self.device))
                    if self._is_tail:
                        y = y[:, -1:]
                    y = y.cpu().numpy()
                except Exception:
                    failures.append(BatchEnvelope(
                        [e], b"", error=traceback.format_exc()))
                    continue
                finally:
                    t1 = time.perf_counter()
                    compute_s += t1 - t0
                    with self._stats_lock:
                        self.window.prefill_s += t1 - t0
                        self.window.prefill_tokens += x.shape[1]
                    if self.spans.on:
                        self._span("prefill", t0, t1, [e])
                # a slot even when the slice holds no stateful layer
                # (caches == {}): residency doubles as the routing check a
                # later step validates against, and the bank stages its
                # steps' inputs
                try:
                    self.sessions.open(e.session, functools.partial(
                        self._take_slot, caches, x[:, :1]))
                except Exception:
                    failures.append(BatchEnvelope(
                        [e], b"", error=traceback.format_exc()))
                    continue
                padded += x.shape[0]
                outs.append(([e], {out_name: y}))
            elif e.kind == K_STEP:
                steps.append((e, np.asarray(x)))
            else:
                failures.append(BatchEnvelope(
                    [e], b"",
                    error=f"unknown session frame kind {e.kind}"))
        # slots are looked up after the group's opens, which may have
        # evicted a session; one step apply a bank, each slot in it once
        waves: list[list[tuple[RowExtent, np.ndarray, Slot]]] = []
        for e, x in steps:
            slot = self.sessions.get(e.session)
            if slot is None:
                failures.append(BatchEnvelope([e], b"", error=(
                    f"SessionLost: stage {self.index} replica "
                    f"{self.replica} holds no KV cache for session "
                    f"{e.session!r} (evicted, repartitioned, or the "
                    "replica restarted); re-open the session from "
                    "its retained history")))
                continue
            for wave in waves:
                if wave[0][2].bank is slot.bank \
                        and all(s is not slot for _, _, s in wave):
                    wave.append((e, x, slot))
                    break
            else:
                waves.append([(e, x, slot)])
        for wave in waves:
            s_out, s_fail, s_compute = self._step_wave(wave, out_name)
            outs.extend(s_out)
            failures.extend(s_fail)
            compute_s += s_compute
            padded += self._step_rows
        return outs, failures, compute_s, padded

    def _take_slot(self, caches: Any, x: np.ndarray) -> Slot:
        """A free slot of the pool for a session of ``caches`` (its
        prefill's) whose steps take inputs like ``x``, holding a copy of
        them; a new bank where every slot of this signature is held."""
        key = signature(caches, x)
        bank = next((b for b in self._banks if b.key == key and b.free),
                    None)
        if bank is None:
            bank = StepStaging(self._decode_apply, self._step_rows, caches,
                               x, self.device, self.step_tallies)
            self._banks.append(bank)
            with self._stats_lock:
                self.window.step_counts["pool_banks"] += 1
        slot = bank.take(caches)
        with self._stats_lock:
            self.window.step_counts["pool_fills"] += 1
        return slot

    def _step_wave(self, wave: list[tuple[RowExtent, np.ndarray, Slot]],
                   out_name: str
                   ) -> tuple[list, list[BatchEnvelope], float]:
        """One step apply over ``wave``'s sessions, whose slots are rows of
        one bank (on a CUDA device, a replay of its graph after the first
        step).

        Each session's token and position are staged at its slot, which
        the step marks live; the step reads and writes the live rows'
        caches in place and leaves every other row's as they were.  A
        session's output is its slot's row.  A step that raises leaves the
        wave's caches undefined, so their sessions are dropped: each
        re-prefills."""
        bank = wave[0][2].bank
        t0 = time.perf_counter()
        try:
            bank.stage([s.row for _, _, s in wave],
                       np.concatenate([x for _, x, _ in wave], axis=0),
                       [e.pos for e, _, _ in wave])
            t1 = time.perf_counter()
            y, how = bank.step()
            t2 = time.perf_counter()
            y = y.cpu().numpy()
        except Exception:
            tb = traceback.format_exc()
            for e, _, _ in wave:
                self.sessions.pop(e.session)
            return [], [BatchEnvelope([e], b"", error=tb)
                        for e, _, _ in wave], time.perf_counter() - t0
        t3 = time.perf_counter()
        if how in (REPLAY, EAGER):
            self.step_times.add(t3 - t0)
        outs = [([e], {out_name: y[s.row:s.row + 1]}) for e, _, s in wave]
        t4 = time.perf_counter()
        phases = tuple(zip(STEP_PHASES, (t0, t1, t2, t3), (t1, t2, t3, t4)))
        with self._stats_lock:
            w = self.window
            for p, a, b in phases:
                w.step_s[p] += b - a
            for k in _COUNTED[how]:
                w.step_counts[k] += 1
            w.step_counts["step_live_rows"] += len(wave)
            w.step_counts["step_rows_run"] += bank.rows
        if self.spans.on:
            steps = [e for e, _, _ in wave]
            for p, a, b in phases:
                self._span(f"step.{p}", a, b, steps)
        return outs, [], t3 - t0

    # -- stage 3: egress (encode once per bucket, relay) ----------------------
    def _relay(self, item: Any) -> None:
        """Send one item downstream.

        A DEAD downstream link (socket reset) is swallowed: the item is
        lost either way — the chain is already severed past this hop —
        and an egress thread dying on the send would leave the internal
        queues undrained and deadlock shutdown on top of the network
        failure.  Any OTHER send failure (e.g. a payload the byte framing
        refuses) is per-batch: the envelope's extents travel on as an
        error envelope so the collector fails exactly those futures
        instead of the request silently hanging."""
        if self.next_inbox is None:
            return
        if isinstance(item, BatchEnvelope):
            item.t_put = time.perf_counter()
        try:
            self.next_inbox.send(item)
        except (ChannelClosed, OSError):
            pass
        except Exception:
            if not isinstance(item, BatchEnvelope):
                return          # tokens/markers always frame: link fault
            try:
                self.next_inbox.send(BatchEnvelope(
                    item.extents, b"", error=traceback.format_exc(),
                    epoch=item.epoch))
            except Exception:  # deferlint: swallow(error envelope itself unencodable; no further signal possible)
                pass

    def _egress_loop(self) -> None:
        while True:
            item = self._to_encode.get()
            if item is _RETIRE:
                # single-replica drain: exit WITHOUT forwarding — the
                # downstream stage must not count a retired replica's stop
                return
            if item is _STOP:
                self._relay(_STOP)
                return
            if isinstance(item, ReconfigMarker):
                # epoch fence: everything encoded after this point was
                # computed on the new partition — stamp it so the next
                # stage's router can hold it behind its own fence barrier
                self._egress_epoch = item.epoch
                self._relay(item)
                continue
            if isinstance(item, BatchEnvelope):
                # error passthrough: relay in order, stamped
                item.epoch = self._egress_epoch
                with self._stats_lock:
                    self._inflight_n -= len(item.extents)
                self._relay(item)
                continue
            extents_all = [e for ext, _ in item.buckets for e in ext]
            waits = self._waited("to_encode", item.t_put, extents_all)
            # book only codec time as encode busy; the relay puts can block
            # on the next node's bounded inbox (backpressure, not work)
            enc_busy = 0.0
            out_envs: list[BatchEnvelope] = []
            first = None
            for extents, res in item.buckets:
                t0 = time.perf_counter()
                first = t0 if first is None else first
                try:
                    blob, rec = self.data_codec.encode_tree(
                        res, "data", request_id=extents[0].request_id,
                        client_id=extents[0].client_id)
                    env = BatchEnvelope(extents, blob,
                                        epoch=self._egress_epoch)
                    item.trace.serialize_s += rec.encode_s
                    item.trace.payload_bytes += rec.wire_bytes
                    item.trace.encodes += 1
                except Exception:
                    env = BatchEnvelope(extents, b"",
                                        error=traceback.format_exc(),
                                        epoch=self._egress_epoch)
                t1 = time.perf_counter()
                enc_busy += t1 - t0
                out_envs.append(env)
            with self._stats_lock:
                self.busy_encode_s += enc_busy
                self.window.wait_s["to_encode"] += waits
                self._record_trace(item.trace)
                self._inflight_n -= sum(len(e.extents) for e in out_envs)
            if self.spans.on and first is not None:
                self._span("encode", first, t1, extents_all)
            t0 = time.perf_counter()
            for env in out_envs:
                self._relay(env)
            if self.spans.on:
                self._span("relay", t0, time.perf_counter(), extents_all)
