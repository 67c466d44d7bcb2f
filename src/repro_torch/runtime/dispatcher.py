"""The DEFER dispatcher (paper Algorithm 1), topology-first, in-process.

The dispatcher builds whatever a :class:`~repro_torch.runtime.topology.TopologySpec`
declares — stages x replicas x transports — instead of the original
hard-wired linear chain.  It partitions the model, ships architecture +
weights to every replica of every stage (configuration step), then serves a
*multi-client* inference stream: a bounded admission queue applies
backpressure at the front door, a pump thread feeds the first stage's
router, each stage's router spreads whole batches across its replicas
(round-robin or least-queue-depth), and a collector thread decodes each
tail envelope ONCE, slices per-request rows back out, and resolves the
per-request futures through a **sequence-numbered merge**: results are
released strictly in each client's submission order, so FIFO-per-client
holds even when replicated stages complete batches out of order (the
batching chain may still legally reorder across clients).  A batch that
failed inside a node arrives as an ``error`` envelope; the collector fails
exactly those futures with :class:`NodeError` while the chain keeps
serving.

Live mutation rides one mechanism, the epoch fence
(:class:`~repro_torch.runtime.wire.ReconfigMarker` + per-stage router barriers):

* :meth:`reconfigure` moves the partition boundaries (weight-diff
  shipping, all replicas of a stage swap at the fence), and
* :meth:`scale` grows or drains a stage's replica count — spawn = ship
  the stage's weights to fresh replicas and fence them into the routing
  set; drain = fence them out, let them flush, retire.

Both guarantee zero dropped, duplicated, or per-client-reordered
responses; both are what the serving controller actuates.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import queue
import threading
import time
import traceback
from collections import defaultdict, deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, Iterable, Sequence

import numpy as np
import torch

from repro_torch.core.graph import LayerGraph
from repro_torch.device import get_device
from repro_torch.core.partitioner import LinkModel, Partition, partition
from repro_torch.runtime.node import _STOP, ComputeNode
from repro_torch.runtime.router import FenceTally, StageGroup
from repro_torch.runtime.topology import TopologySpec
from repro_torch.runtime.transport import Channel, ChannelClosed, get_transport
from repro_torch.runtime.wire import (BatchEnvelope, NodePlan, ReconfigMarker,
                                      RowExtent, WireCodec, WireRecord,
                                      slice_parts, validate_client_id)


class AdmissionFull(Exception):
    """The bounded admission queue is full, or the submitting client hit its
    in-flight quota (backpressure reached the client)."""


class NodeError(RuntimeError):
    """A request's batch failed inside a compute node; carries the remote
    traceback.  The node survives and keeps serving other requests."""


class DeadlineExceeded(RuntimeError):
    """A request's end-to-end deadline (``submit(deadline_s=...)``) expired
    before its result was released to the client.  The future fails with
    this; any late result arriving afterwards is dropped by the collector's
    at-most-once rule, never delivered."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Replay policy for infrastructure failures (the request-reliability
    layer).  With a policy set, the dispatcher retains each in-flight
    request's encoded input and re-admits requests stranded by a replica
    crash / severed link / dead tail under an incremented ``attempt`` tag
    — application errors raised by user ``apply`` code are NEVER retried.

    ``max_attempts`` bounds TOTAL attempts (first admission included).
    ``backoff_s`` delays re-admission by ``backoff_s * backoff_factor **
    (attempt - 1)`` so a heal (respawn, rerouted link) has time to land.
    ``retry_budget`` is a token bucket (capacity ``retry_budget`` tokens,
    refilling at ``refill_per_s``): every replay spends one token, and
    when the bucket is dry the dispatcher degrades gracefully back to the
    PR 7 fail-fast semantics instead of amplifying a crash storm."""

    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    retry_budget: float = 32.0
    refill_per_s: float = 8.0


@dataclasses.dataclass
class ReplayStats:
    """Counters for the reliability layer (windowless, monotonic)."""

    replays: int = 0             # re-admissions actually scheduled
    stale_failures: int = 0      # failure reports for a superseded attempt
    budget_denied: int = 0       # replays refused: token bucket dry
    attempts_exhausted: int = 0  # replays refused: max_attempts reached
    deadline_denied: int = 0     # replays refused: not enough deadline left
    deadlines_expired: int = 0   # futures failed with DeadlineExceeded
    tail_revives: int = 0        # result channel rebuilt after a tail death


class _Retained:
    """Everything needed to re-admit one in-flight request: its encoded
    input blob plus the admission metadata.  ``attempt`` is the attempt
    currently in flight; a failure report carrying an older attempt is
    stale and absorbed without action."""

    __slots__ = ("blob", "client_id", "seq", "rows", "priority",
                 "t_submit", "deadline", "deadline_s", "attempt")

    def __init__(self, blob: bytes, client_id: Any, seq: int, rows: int,
                 priority: int, t_submit: float,
                 deadline: float | None, deadline_s: float | None):
        self.blob = blob
        self.client_id = client_id
        self.seq = seq
        self.rows = rows
        self.priority = priority
        self.t_submit = t_submit
        self.deadline = deadline        # monotonic-clock expiry, or None
        self.deadline_s = deadline_s    # original budget (error messages)
        self.attempt = 0


@dataclasses.dataclass
class DispatcherCodecs:
    """Per-payload-type codec choice (the paper's three socket configs)."""

    architecture: WireCodec = WireCodec("raw", "none")   # JSON spec, tiny
    weights: WireCodec = WireCodec("raw", "none")
    data: WireCodec = WireCodec("zfp", "none", zfp_rate=16)


class _WeightedAdmissionQueue:
    """Bounded admission queue with weighted-fair dequeue across priority
    bands.

    ``put`` files an item under its priority band (higher = more urgent)
    and applies the same bounded-capacity backpressure as a plain FIFO.
    ``get`` runs smooth weighted round-robin over the non-empty bands with
    weight ``priority + 1``: a priority-1 client is dequeued ~2x as often
    as a priority-0 client *when both are backlogged*, but low bands keep
    accumulating credit, so nothing starves.  Within a band, FIFO.

    ``put(_STOP)`` latches a stop flag instead of enqueueing, and ``get``
    surfaces _STOP only once every band is drained — the stop token can
    never overtake an admitted request (shutdown(drain=False) still
    completes in-flight work, exactly like the old FIFO)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._bands: dict[int, deque] = {}
        self._credit: dict[int, float] = {}
        self._size = 0
        self._stopped = False
        self._mutex = threading.Lock()
        self._not_empty = threading.Condition(self._mutex)
        self._not_full = threading.Condition(self._mutex)

    def qsize(self) -> int:
        with self._mutex:
            return self._size

    def put(self, item: Any, block: bool = True,
            timeout: float | None = None, priority: int = 0) -> None:
        with self._not_full:
            if item is _STOP:
                self._stopped = True
                self._not_empty.notify_all()
                return
            if self._size >= self.maxsize:
                if not block or not self._not_full.wait_for(
                        lambda: self._size < self.maxsize, timeout=timeout):
                    raise queue.Full
            band = self._bands.setdefault(priority, deque())
            self._credit.setdefault(priority, 0.0)
            band.append(item)
            self._size += 1
            self._not_empty.notify()

    def get(self) -> Any:
        with self._not_empty:
            self._not_empty.wait_for(
                lambda: self._size > 0 or self._stopped)
            if self._size == 0:          # stopped AND fully drained
                return _STOP
            # smooth weighted round-robin: every backlogged band earns its
            # weight, the richest band is served and pays the round total
            total = 0.0
            for p, dq in self._bands.items():
                if dq:
                    w = max(1.0, p + 1.0)    # sub-zero priorities still run
                    self._credit[p] += w
                    total += w
            pick = max((p for p, dq in self._bands.items() if dq),
                       key=lambda p: (self._credit[p], p))
            self._credit[pick] -= total
            item = self._bands[pick].popleft()
            self._size -= 1
            self._not_full.notify()
            return item


class Dispatcher:
    """Owns the topology: planning, configuration, routing, and the
    admission stream."""

    def __init__(self, graph: LayerGraph, topology: TopologySpec,
                 codecs: DispatcherCodecs | None = None,
                 link: LinkModel | None = None,
                 max_batch: int = 8,
                 admission_depth: int = 64,
                 queue_depth: int = 8,
                 staged: bool = True,
                 client_quota: int | None = None,
                 shape_buckets: str = "exact",
                 max_batch_cap: int | None = None,
                 replica_factory=None,
                 retry_policy: RetryPolicy | None = None,
                 device: str | torch.device | None = None):
        if isinstance(topology, int):
            topology = TopologySpec.chain(graph, topology)
        topology.validate(graph)
        self.graph = graph
        self.topology = topology
        # every replica computes, and every codec runs its kernels, on
        # this one device (None = repro_torch.device.get_device())
        self.device = get_device(device)
        codecs = codecs or DispatcherCodecs()
        self.codecs = DispatcherCodecs(**{
            f.name: dataclasses.replace(getattr(codecs, f.name),
                                        device=self.device)
            for f in dataclasses.fields(codecs)})
        self.link = link
        self._defaults = dict(max_batch=max_batch, queue_depth=queue_depth,
                              staged=staged, shape_buckets=shape_buckets,
                              max_batch_cap=max_batch_cap)
        # optional replica provider: (dispatcher, stage, replica) -> a
        # ComputeNode-shaped object, or None to fall back to the in-process
        # default.  The process-per-replica supervisor plugs in here so
        # spawn (__init__ AND scale) builds worker-backed replicas through
        # the same path as in-process ones.
        self._replica_factory = replica_factory
        self.partition: Partition = partition(
            graph, topology.num_stages,
            link=link, cuts=list(topology.cuts) or None,
            replicas=topology.replicas)

        # wiring: per stage, an input channel (fed by the pump or by the
        # previous stage's replicas) and a router spreading it across the
        # stage's replicas; the last stage feeds the collector's channel.
        # Every channel this dispatcher opens is tracked so shutdown can
        # close it — returning it to its transport's live count (a
        # re-registration of the transport name is refused while channels
        # are live) and releasing socket/link resources
        self._channels: list[Channel] = []
        self._stage_inputs: list[Channel] = [
            self._open_channel(s.transport, queue_depth)
            for s in topology.stages]
        self.result_channel: Channel = self._open_channel(
            topology.stages[-1].transport, 0)
        self.stages: list[StageGroup] = []
        for i, spec in enumerate(topology.stages):
            replicas = [self._make_replica(i, r)
                        for r in range(spec.replicas)]
            group = StageGroup(i, spec, replicas, self._stage_inputs[i],
                               upstream=self.stages[i - 1] if i else None,
                               fail_batch=self._finish_batch,
                               note_displaced=self._note_displaced)
            self.stages.append(group)
        for i, group in enumerate(self.stages):
            nxt = (self._stage_inputs[i + 1] if i + 1 < len(self.stages)
                   else self.result_channel)
            for node in group.replicas:
                node.next_inbox = nxt

        self.config_records: list[WireRecord] = []
        self.admission = _WeightedAdmissionQueue(admission_depth)
        # per-client admission quota: max in-flight (admitted, unresolved)
        # requests per client_id; None = unlimited
        self.client_quota = client_quota
        self._client_inflight: dict[Any, int] = defaultdict(int)
        # windowed stats (cleared by reset_stats): dispatcher-side encode
        # records and admission->result latencies
        self.feed_records: list[WireRecord] = []
        self.latencies: list[float] = []
        self._futures: dict[int, Future] = {}
        self._next_id = 0
        self._client_seq: dict[Any, int] = defaultdict(int)
        # the sequenced merge: per client, results arriving out of
        # submission order (replicated stages complete out of order) are
        # held and released strictly by seq, so per-client responses are
        # never reordered; seqs whose submit failed before admission are
        # cancelled so the merge never stalls on a hole
        self._client_next: dict[Any, int] = defaultdict(int)
        self._client_hold: dict[Any, dict[int, tuple]] = defaultdict(dict)
        self._client_cancel: dict[Any, set[int]] = defaultdict(set)
        self._inflight = 0
        self._admitting = 0        # registered but not yet on the admission q
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        # request-reliability layer: input retention + replay + deadlines.
        # All timing here is MONOTONIC clock (deferlint DL103): deadlines
        # and backoff must never jump with wall-clock adjustments.
        self.retry_policy = retry_policy
        self.replay_stats = ReplayStats()
        self._retained: dict[int, _Retained] = {}
        self._retry_tokens = (float(retry_policy.retry_budget)
                              if retry_policy else 0.0)
        self._retry_refill_t = time.monotonic()
        # one timer thread services both event kinds off a heap of
        # (due_monotonic, kind, rid, attempt); kind 0 = deadline expiry,
        # kind 1 = backoff-delayed replay re-admission.  Started lazily on
        # the first submit that needs it; joined by shutdown.
        self._timer_heap: list[tuple[float, int, int, int]] = []
        self._timer_cv = threading.Condition(self._lock)
        self._reaper_thread: threading.Thread | None = None
        self._reaper_stop = False
        self._pump_thread: threading.Thread | None = None
        self._collect_thread: threading.Thread | None = None
        self._configured = False
        self._started = False
        self._closed = False
        self._tail_dead = False        # set when the result channel dies
        # live-mutation state: reconfigure()/scale() are serialized, the
        # epoch counts committed fences, and the event acknowledges the
        # fence barrier completing at the tail (chain-wide swap done)
        self.epoch = 0
        self.reconfig_records: list[dict] = []
        self._params: dict[str, Any] | None = None
        self._reconfig_lock = threading.Lock()
        self._reconfig_event: threading.Event | None = None
        self._reconfig_expect = 0      # epoch the pending event waits for
        # tail barrier state (collector thread only): the collector is the
        # degenerate downstream consumer of the last stage, sharing the
        # routers' FenceTally accounting
        self._tail = FenceTally(len(self.stages[-1].replicas))
        # decode-session bookkeeping: active session ids (registered by the
        # generate loop, unregistered on close — the per-client-GC
        # precedent, so ephemeral sessions can't grow this without bound)
        # and the displaced set (sessions whose sticky replica was drained
        # or died; the generate loop pops its id and re-prefills before the
        # next step instead of burning a step on a guaranteed SessionLost)
        self._active_sessions: set = set()
        self._displaced_sessions: set = set()

    def _open_channel(self, transport: str, capacity: int) -> Channel:
        ch = get_transport(transport).channel(capacity)
        self._channels.append(ch)
        return ch

    def _make_node(self, stage: int, replica: int) -> ComputeNode:
        """One replica of one stage, with the stage spec's overrides
        applied over the engine-wide defaults."""
        spec = self.topology.stages[stage]
        d = self._defaults
        node = ComputeNode(
            stage, self.codecs.data, replica=replica,
            queue_depth=d["queue_depth"],
            max_batch=spec.max_batch or d["max_batch"],
            staged=d["staged"],
            shape_buckets=spec.shape_buckets or d["shape_buckets"],
            max_batch_cap=spec.max_batch_cap or d["max_batch_cap"],
            inbox=self._open_channel(spec.transport, d["queue_depth"]),
            session_capacity=spec.session_capacity or 64,
            device=self.device)
        if spec.coalesce_s is not None:
            node.coalesce_s = spec.coalesce_s
        return node

    def _make_replica(self, stage: int, replica: int) -> ComputeNode:
        """One replica via the pluggable factory (process-backed workers)
        or the in-process default.  A factory may return None for stages
        it does not manage."""
        if self._replica_factory is not None:
            node = self._replica_factory(self, stage, replica)
            if node is not None:
                return node
        return self._make_node(stage, replica)

    @property
    def nodes(self) -> list[ComputeNode]:
        """Every live replica, stage-major (stats/report convenience);
        prunes dead retirees as a side effect (see live_replicas)."""
        return [r for g in self.stages for r in g.live_replicas()]

    @property
    def replicas(self) -> tuple[int, ...]:
        return tuple(len(g.live_replicas()) for g in self.stages)

    # -- configuration step --------------------------------------------------
    def _stage_blobs(self, stage: int, lo: int, hi: int,
                     record: bool = True) -> tuple[bytes, bytes]:
        """Wire-encode one stage's architecture spec + full weights."""
        names = [n.name for n in self.graph.slice_nodes(lo, hi)]
        spec = {"layers": names,
                "next": stage + 1 if stage + 1 < len(self.stages) else None}
        arch_blob = json.dumps(spec).encode()
        t0 = time.perf_counter()
        if self.codecs.architecture.compression == "lz4":
            from repro_torch.core.codecs import Lz4Codec
            arch_wire = Lz4Codec().compress(arch_blob)
        else:
            arch_wire = arch_blob
        t1 = time.perf_counter()
        if record:
            self.config_records.append(WireRecord(
                "architecture", len(arch_blob), len(arch_wire), t1 - t0))
        stage_params = {name: self._params[name] for name in names}
        weights_blob, rec = self.codecs.weights.encode_tree(
            stage_params, "weights")
        if record:
            self.config_records.append(rec)
        return arch_blob, weights_blob

    def configure(self, params: dict[str, Any]) -> None:
        """Ship each stage's architecture + weights over the wire — once
        per replica (each replica holds the full stage)."""
        # the dispatcher owns the full model (paper setting): retained so a
        # live repartition can ship the weight DIFF of shifted layers only,
        # and so scale() can configure freshly spawned replicas
        self._params = params
        for group, (lo, hi) in zip(self.stages, self.partition.ranges()):
            arch_blob, weights_blob = self._stage_blobs(group.index, lo, hi)
            for node in group.replicas:
                node.configure(self.graph, lo, hi, arch_blob, weights_blob,
                               self.codecs.weights)
        self._configured = True

    def precompile(self) -> None:
        """Compile every batch-size specialization on every replica up
        front (see :meth:`ComputeNode.precompile`)."""
        assert self._configured, "configure() before precompile()"
        for node in self.nodes:
            node.precompile()

    # -- distributed inference step -------------------------------------------
    def start(self) -> None:
        assert self._configured, "configure() before start()"
        if self._started:
            return
        self._started = True
        # every replica built, not ``self.nodes``: that prunes a replica
        # that died (a worker process that exited) before start, and a
        # stage left with no member would start its router empty, never
        # forward _STOP, and hang shutdown; starting it raises instead
        for group in self.stages:
            for node in list(group.replicas):
                node.start()
        for group in self.stages:
            group.start()
        self._pump_thread = threading.Thread(target=self._pump, daemon=True)
        self._pump_thread.start()
        self._collect_thread = threading.Thread(target=self._collect,
                                                daemon=True)
        self._collect_thread.start()

    def _pump(self) -> None:
        """Admission queue -> first stage's router (the dispatcher's
        outbound socket).  Keeping this off the caller thread means
        submit() returns as soon as the request is *admitted*, not
        relayed."""
        head = self._stage_inputs[0]
        while True:
            env = self.admission.get()
            if env is _STOP:
                try:
                    head.send(_STOP)
                except (ChannelClosed, OSError):
                    pass                # head link dead: nothing to stop
                return
            try:
                head.send(env)
            except (ChannelClosed, OSError):
                # dead head link: an infrastructure failure — the replay
                # layer may re-admit once the chain heals.  Keep pumping
                # (mirrors the router's per-batch isolation).
                self._finish_batch(env.extents, error=traceback.format_exc(),
                                   retryable=True)
            except Exception:
                # anything else (encode/framing bug) is not healable
                self._finish_batch(env.extents, error=traceback.format_exc())

    def _collect(self) -> None:
        """Tail of the topology -> per-request futures, released in
        per-client seq order by the sequenced merge.

        One decode per tail envelope; per-request rows are sliced back out
        of the stacked payload by the envelope's row-extent framing.  The
        collector is also the tail end of every fence: it completes the
        marker barrier over the last stage's replicas and acknowledges the
        epoch chain-wide."""
        while True:
            try:
                item = self.result_channel.recv()
            except ChannelClosed:
                # tail link dead.  With a retry policy, rebuild the tail
                # channel in place and replay what was in flight (the
                # un-bricking path); without one, no result can ever
                # arrive again — fail every unresolved future NOW (a
                # silent return would hang every blocked client and
                # shutdown's drain forever) and refuse new admissions
                if self._try_revive_tail():
                    continue
                self._fail_all_pending(
                    "result channel closed: the chain's tail link died")
                return
            if item is _STOP:
                if self._tail.on_stop():
                    if not self._closed:
                        # a stop cascade the dispatcher did not initiate:
                        # a mid-chain link died and its router flushed the
                        # chain out.  Everything still in flight is
                        # undeliverable — fail it (and further submits)
                        # instead of exiting with clients left hanging
                        self._fail_all_pending(
                            "the chain stopped unexpectedly (a mid-chain "
                            "link died); request undeliverable")
                    return
                continue
            if isinstance(item, ReconfigMarker):
                e = item.epoch
                if not self._tail.on_marker(e, self.stages[-1]):
                    continue
                # the epoch fence cleared the whole topology: every replica
                # of every stage swapped.  Ack by epoch — a stale fence
                # from an earlier timed-out mutation must not acknowledge
                # a later one
                ev = self._reconfig_event
                if ev is not None and e >= self._reconfig_expect:
                    ev.set()
                if self._tail.stopped:
                    # shutdown raced an in-flight drain fence of the last
                    # stage (see FenceTally): the retired replica never
                    # stops, so the last live stop may precede this fence
                    if not self._closed:
                        self._fail_all_pending(
                            "the chain stopped unexpectedly (a mid-chain "
                            "link died); request undeliverable")
                    return
                continue
            env: BatchEnvelope = item
            if env.error is not None:
                self._finish_batch(env.extents, error=env.error,
                                   retryable=env.retryable)
                continue
            try:
                flat, _ = self.codecs.data.decode_tree(env.blob)
                flat = {k: np.asarray(v) for k, v in flat.items()}
                parts = slice_parts(flat, env.extents)
            except Exception:               # codec failure at the tail
                self._finish_batch(env.extents, error=traceback.format_exc())
                continue
            results = [(next(iter(p.values())) if len(p) == 1 else p)
                       for p in parts]
            self._finish_batch(env.extents, results=results)

    def _release_locked(self, client: Any, now: float) -> list[tuple]:
        """Pop every in-order (by seq) completed result for ``client``.
        Caller holds ``_lock``; resolves futures AFTER dropping it."""
        out: list[tuple] = []
        nxt = self._client_next[client]
        hold = self._client_hold[client]
        cancel = self._client_cancel[client]
        while True:
            if nxt in cancel:               # submit failed pre-admission:
                cancel.discard(nxt)         # the hole is not a lost result
                nxt += 1
                continue
            entry = hold.pop(nxt, None)
            if entry is None:
                break
            fut, res, err, ext = entry
            if err is None:
                # failures resolve fast by construction — mixing their
                # time-to-failure into the percentiles would *improve*
                # reported latency as the error rate rises
                self.latencies.append(now - ext.t_submit)
            self._inflight -= 1
            self._client_inflight[client] -= 1
            out.append((fut, res, err))
            nxt += 1
        self._client_next[client] = nxt
        if (self._client_inflight.get(client, 0) == 0 and not hold
                and not cancel):
            # idle client fully drained: drop its merge/quota/seq state so
            # ephemeral client ids (per-request UUIDs) can't grow these
            # maps without bound.  Seq and next are dropped TOGETHER — a
            # returning client restarts a consistent fresh sequence.
            for m in (self._client_hold, self._client_cancel,
                      self._client_next, self._client_seq,
                      self._client_inflight):
                m.pop(client, None)
        if out:
            self._idle.notify_all()
        return out

    @staticmethod
    def _resolve(done: list[tuple]) -> None:
        """Resolve released futures — called OUTSIDE the lock.  First-wins
        is structural: each rid's future is popped from ``_futures``
        exactly once, so a second resolution attempt cannot reach here."""
        for fut, res, err in done:
            if err is not None:
                exc = (err if isinstance(err, BaseException)
                       else NodeError(
                           f"request failed inside the chain:\n{err}"))
                fut.set_exception(exc)
            else:
                fut.set_result(res)

    def _fail_all_pending(self, reason: str) -> None:
        """Terminal failure path: the chain can no longer deliver results
        (tail link dead).  Every unresolved future — registered or held
        in the sequenced merge — fails with :class:`NodeError`, the merge
        state is cleared so ``drain``/``shutdown`` complete, and further
        submits are refused."""
        with self._lock:
            self._tail_dead = True
            failed = list(self._futures.values())
            self._futures.clear()
            for hold in self._client_hold.values():
                failed.extend(entry[0] for entry in hold.values())
            self._client_hold.clear()
            self._client_cancel.clear()
            self._client_next.clear()
            self._client_seq.clear()
            self._client_inflight.clear()
            self._inflight = 0
            self._retained.clear()
            self._timer_heap.clear()
            self._timer_cv.notify_all()
            self._idle.notify_all()
        for fut in failed:
            try:
                fut.set_exception(NodeError(reason))
            except InvalidStateError:
                pass                    # already resolved: nothing owed

    def _finish_batch(self, extents: list[RowExtent],
                      results: list | None = None,
                      error: str | BaseException | None = None,
                      retryable: bool = False) -> None:
        now = time.perf_counter()
        done: list[tuple] = []
        with self._lock:
            for idx, ext in enumerate(extents):
                if (error is not None and retryable
                        and self._absorb_failure_locked(ext)):
                    continue            # replay scheduled (or stale report)
                fut = self._futures.pop(ext.request_id, None)
                if fut is None:
                    continue            # at-most-once: already resolved
                self._retained.pop(ext.request_id, None)
                self._client_hold[ext.client_id][ext.seq] = (
                    fut, results[idx] if results is not None else None,
                    error, ext)
                done.extend(self._release_locked(ext.client_id, now))
        self._resolve(done)

    # -- request reliability: replay + deadlines --------------------------------
    def _absorb_failure_locked(self, ext: RowExtent) -> bool:
        """Decide one retryable failure's fate.  Caller holds ``_lock``.

        True means the failure is absorbed — either a replay was scheduled
        under an incremented attempt, or the report is stale (it names an
        attempt the dispatcher already superseded).  False means replay is
        refused (no policy, exhausted attempts, deadline too close, token
        bucket dry, shutting down) and the caller fails the future — the
        graceful degradation back to PR 7 fail-fast semantics."""
        pol = self.retry_policy
        if pol is None or self._closed or self._tail_dead:
            return False
        rec = self._retained.get(ext.request_id)
        if rec is None or not rec.blob:
            # nothing retained to replay (deadline-only metadata, or a
            # session step whose recovery belongs to the session layer)
            return False
        if ext.attempt != rec.attempt:
            # a failure report for an earlier attempt of a request that
            # was already re-admitted: the live attempt owns the outcome
            self.replay_stats.stale_failures += 1
            return True
        if rec.attempt + 1 >= pol.max_attempts:
            self.replay_stats.attempts_exhausted += 1
            return False
        backoff = pol.backoff_s * pol.backoff_factor ** rec.attempt
        if rec.deadline is not None and (
                time.monotonic() + backoff + self._latency_est_locked()
                >= rec.deadline):
            # not enough deadline budget left for another chain traversal:
            # fail now rather than burn a token on a doomed replay
            self.replay_stats.deadline_denied += 1
            return False
        if not self._take_retry_token_locked():
            self.replay_stats.budget_denied += 1
            return False
        rec.attempt += 1
        self.replay_stats.replays += 1
        heapq.heappush(self._timer_heap,
                       (time.monotonic() + backoff, 1,
                        ext.request_id, rec.attempt))
        self._ensure_reaper_locked()
        self._timer_cv.notify()
        return True

    def _take_retry_token_locked(self) -> bool:
        """Token bucket: one token per replay, refilled continuously."""
        pol = self.retry_policy
        now = time.monotonic()
        self._retry_tokens = min(
            float(pol.retry_budget),
            self._retry_tokens + (now - self._retry_refill_t)
            * pol.refill_per_s)
        self._retry_refill_t = now
        if self._retry_tokens < 1.0:
            return False
        self._retry_tokens -= 1.0
        return True

    def _latency_est_locked(self) -> float:
        """Calibrated end-to-end chain latency (median of the stats
        window) — the replay/deadline arbiter's cost model."""
        if not self.latencies:
            return 0.0
        return float(np.median(self.latencies[-256:]))

    def _ensure_reaper_locked(self) -> None:
        if self._reaper_thread is None and not self._reaper_stop:
            self._reaper_thread = threading.Thread(target=self._reaper,
                                                   daemon=True)
            self._reaper_thread.start()

    def _reaper(self) -> None:
        """Timer thread: fires deadline expiries and backoff-delayed
        replays off the monotonic-clock heap.  One thread serves both so
        ordering between a deadline and a replay of the same request is a
        heap comparison, not a thread race."""
        while True:
            with self._lock:
                while True:
                    if self._reaper_stop:
                        return
                    if self._timer_heap:
                        wait = self._timer_heap[0][0] - time.monotonic()
                        if wait <= 0:
                            break
                        self._timer_cv.wait(timeout=wait)
                    else:
                        self._timer_cv.wait()
                due, kind, rid, attempt = heapq.heappop(self._timer_heap)
            if kind == 0:
                self._expire_deadline(rid)
            else:
                self._replay_now(rid, attempt)

    def _expire_deadline(self, rid: int) -> None:
        """Fail one request with DeadlineExceeded — routed through the
        sequenced merge (NOT a bare set_exception) so the client's seq
        stream has no hole and later responses still release."""
        with self._lock:
            rec = self._retained.get(rid)
            if rec is None or rid not in self._futures:
                return                  # already resolved / cancelled
            ext = RowExtent(rid, rec.client_id, rec.seq, rec.rows,
                            t_submit=rec.t_submit, attempt=rec.attempt)
            self.replay_stats.deadlines_expired += 1
        self._finish_batch([ext], error=DeadlineExceeded(
            f"request {rid} missed its {rec.deadline_s:.3g}s deadline; "
            "any late result will be dropped, not delivered"))

    def _replay_now(self, rid: int, attempt: int) -> None:
        """Re-admit one stranded request through the NORMAL admission
        path (FIFO-per-client and the sequenced merge hold: the request
        keeps its original client_id/seq, only ``attempt`` moves)."""
        with self._lock:
            rec = self._retained.get(rid)
            if rec is None or rid not in self._futures \
                    or rec.attempt != attempt:
                return                  # resolved or superseded meanwhile
            if self._closed or self._tail_dead:
                abandon = True
            else:
                abandon = False
                # shutdown waits for _admitting == 0 before latching _STOP,
                # so a replay mid-put cannot be overtaken by the stop token
                self._admitting += 1
        if abandon:
            self._finish_batch([RowExtent(rid, rec.client_id, rec.seq,
                                          rec.rows, t_submit=rec.t_submit,
                                          attempt=rec.attempt)],
                               error="replay abandoned: dispatcher "
                                     "shutting down")
            return
        env = BatchEnvelope(
            [RowExtent(rid, rec.client_id, rec.seq, rec.rows,
                       t_submit=rec.t_submit, attempt=rec.attempt)],
            rec.blob)
        try:
            self.admission.put(env, block=True, timeout=5.0,
                               priority=rec.priority)
        except queue.Full:
            self._finish_batch(env.extents,
                               error="replay re-admission refused "
                                     "(admission queue full)")
        finally:
            with self._lock:
                self._admitting -= 1
                self._idle.notify_all()

    def _try_revive_tail(self) -> bool:
        """Un-brick a dead tail: open a fresh result channel, re-point the
        last stage's replicas at it, and push every in-flight request back
        through the replay arbiter.  Only with a retry policy — without
        one the PR 7 fail-fast path (``_fail_all_pending``) stands."""
        with self._lock:
            if (self.retry_policy is None or self._closed
                    or self._tail_dead):
                return False
            retained = [(rid, rec) for rid, rec in self._retained.items()
                        if rid in self._futures]
        old = self.result_channel
        ch = self._open_channel(self.topology.stages[-1].transport, 0)
        self.result_channel = ch
        # replicas' relay loops re-read next_inbox per item, so the swap
        # takes effect on their next send without restarting them
        for node in self.stages[-1].replicas:
            node.next_inbox = ch
        try:
            old.close()
        except Exception:  # deferlint: swallow(old tail channel already dead)
            pass
        self.replay_stats.tail_revives += 1
        if retained:
            # everything in flight may have died with the old channel;
            # replay it (first-wins drops any duplicate that did survive)
            self._finish_batch(
                [RowExtent(rid, rec.client_id, rec.seq, rec.rows,
                           t_submit=rec.t_submit, attempt=rec.attempt)
                 for rid, rec in retained],
                error="the chain's tail link died before this request's "
                      "result was delivered",
                retryable=True)
        return True

    # -- decode sessions --------------------------------------------------------
    def session_register(self, session: Any) -> None:
        """Track one active decode session (the generate loop calls this
        at open and :meth:`session_unregister` on close, so the displaced
        set only ever holds live sessions — bounded by construction)."""
        with self._lock:
            self._active_sessions.add(session)

    def session_unregister(self, session: Any) -> None:
        with self._lock:
            self._active_sessions.discard(session)
            self._displaced_sessions.discard(session)

    def session_displaced(self, session: Any) -> bool:
        """Check-and-clear: True once after the session's sticky replica
        was drained/died or a repartition invalidated every stage's cache
        — the generate loop then re-prefills from its retained history."""
        with self._lock:
            if session in self._displaced_sessions:
                self._displaced_sessions.discard(session)
                return True
            return False

    def _note_displaced(self, sessions: Iterable[Any]) -> None:
        """Router callback: these sessions' pinned replica left the
        routing set (drain at a fence, or death)."""
        with self._lock:
            self._displaced_sessions.update(
                s for s in sessions if s in self._active_sessions)

    # -- admission --------------------------------------------------------------
    def submit(self, x: np.ndarray, client_id: Any = 0,
               block: bool = True, timeout: float | None = None,
               priority: int = 0,
               deadline_s: float | None = None,
               session: Any = None, session_pos: int = 0,
               session_kind: int = 0) -> Future:
        """Admit one request.  Returns a Future resolving to the output.

        ``timeout`` vs ``deadline_s`` — they bound DIFFERENT phases:
        ``timeout`` only bounds how long this call may block waiting for
        admission-queue space (backpressure at the front door); once the
        request is admitted, ``timeout`` plays no further role.
        ``deadline_s`` is the end-to-end result deadline: if the future
        has not resolved ``deadline_s`` seconds (monotonic clock) after
        submission, it fails with :class:`DeadlineExceeded`, replay is
        skipped when the remaining budget is below the calibrated chain
        latency, and a late result is dropped by the at-most-once
        collector, never delivered.

        When the bounded admission queue is full, blocks (``block=True``)
        or raises :class:`AdmissionFull` — that is the backpressure a
        front-end needs to shed load instead of queuing unboundedly.  A
        client at its in-flight quota (``client_quota``) is refused
        immediately with :class:`AdmissionFull` regardless of ``block`` —
        one greedy client can no longer monopolize the admission queue.

        ``priority`` selects the admission band: the pump dequeues bands
        weighted-fair (weight ``priority + 1``), so higher-priority
        backlogged clients drain proportionally faster without starving
        priority 0.  A client's responses are still released in its own
        submission order (the sequenced merge), whatever the priorities
        or replica completion order did to the in-chain ordering.

        ``session``/``session_pos``/``session_kind`` tag decode-session
        traffic (see :mod:`repro_torch.runtime.session`): stage routers pin the
        session to the replica holding its KV cache, and the blind replay
        layer is bypassed — a replayed decode step against a cache that
        died with its replica would silently corrupt the sequence, so
        session recovery is re-prefill from retained history at the
        session layer, never a wire-level replay.
        """
        if not self._started:
            self.start()
        # reject ids the byte framing can't carry HERE, not as a relay
        # failure mid-chain on whichever stage binds a socket transport
        validate_client_id(client_id)
        if session is not None:
            validate_client_id(session)
        fut: Future = Future()
        # one locked section registers the request: any submit that passed
        # the closed check is visible to shutdown() via _admitting/_inflight,
        # so _STOP can never overtake a registered envelope
        with self._lock:
            if self._closed:
                raise RuntimeError("dispatcher is shut down")
            if self._tail_dead:
                raise RuntimeError(
                    "the chain can no longer deliver results (a link "
                    "died); restart the engine")
            if self.client_quota is not None \
                    and self._client_inflight[client_id] >= self.client_quota:
                raise AdmissionFull(
                    f"client {client_id!r} at quota "
                    f"({self.client_quota} in flight)")
            rid = self._next_id
            self._next_id += 1
            seq = self._client_seq[client_id]
            self._client_seq[client_id] += 1
            self._futures[rid] = fut
            self._inflight += 1
            self._client_inflight[client_id] += 1
            self._admitting += 1
        try:
            arr = np.asarray(x)
            blob, rec = self.codecs.data.encode_tree(
                {"": arr}, "data", request_id=rid, client_id=client_id)
            rows = int(arr.shape[0]) if arr.ndim else 1
            t_sub = time.perf_counter()
            env = BatchEnvelope(
                [RowExtent(rid, client_id, seq, rows,
                           t_submit=t_sub, session=session,
                           pos=int(session_pos),
                           kind=int(session_kind))], blob)
            with self._lock:
                self.feed_records.append(rec)
                if ((self.retry_policy is not None and session is None)
                        or deadline_s is not None):
                    # retain the encoded input for replay; a deadline-only
                    # submit (no policy) — and ANY session-tagged submit,
                    # whose recovery is session-layer re-prefill — retains
                    # just the metadata the reaper needs, not the blob
                    ret = _Retained(
                        blob if (self.retry_policy is not None
                                 and session is None) else b"",
                        client_id, seq, rows, priority, t_sub,
                        deadline=(time.monotonic() + deadline_s
                                  if deadline_s is not None else None),
                        deadline_s=deadline_s)
                    self._retained[rid] = ret
                    if ret.deadline is not None:
                        heapq.heappush(self._timer_heap,
                                       (ret.deadline, 0, rid, 0))
                        self._ensure_reaper_locked()
                        self._timer_cv.notify()
            self.admission.put(env, block=block, timeout=timeout,
                               priority=priority)
        except queue.Full:
            self._unregister(rid, client_id, seq)
            raise AdmissionFull(
                f"admission queue full ({self.admission.maxsize} deep)")
        except BaseException:
            self._unregister(rid, client_id, seq)
            raise
        with self._lock:
            self._admitting -= 1
            self._idle.notify_all()
        return fut

    def _unregister(self, rid: int, client_id: Any, seq: int) -> None:
        """Roll back a registration whose envelope never reached admission.
        The seq is cancelled in the merge so later results can't stall
        behind the hole — and any later-seq results already held behind
        it are released now (nothing else would ever re-drain them)."""
        with self._lock:
            self._futures.pop(rid, None)
            self._retained.pop(rid, None)
            self._client_cancel[client_id].add(seq)
            self._inflight -= 1
            self._client_inflight[client_id] -= 1
            self._admitting -= 1
            done = self._release_locked(client_id, time.perf_counter())
            self._idle.notify_all()
        self._resolve(done)

    def infer_stream(self, inputs: Iterable[np.ndarray],
                     client_id: Any = 0) -> list[np.ndarray]:
        """Blocking shim over submit(): feed all samples, collect in
        submission order (FIFO for this client by construction)."""
        futures = [self.submit(x, client_id=client_id) for x in inputs]
        return [f.result() for f in futures]

    # -- live reconfiguration (the controller's commit path) -------------------
    def reconfigure(self, cuts: Sequence[int],
                    timeout: float | None = 60.0) -> dict:
        """Hot-migrate partition boundaries on the RUNNING topology.

        Two-phase: (1) PREPARE — for each stage whose range changes, build
        a :class:`NodePlan` carrying its new architecture spec and the
        wire-encoded weights of only the layers it GAINS (the weight diff;
        kept layers are reused in place; every replica of the stage applies
        the same plan); (2) COMMIT — inject one :class:`ReconfigMarker` at
        the head of the topology.  The marker rides the same FIFO channels
        as data envelopes; each stage's router barriers it over the
        upstream replicas and broadcasts it to its own, so every replica
        swaps exactly when the fence passes its compute stage: every
        in-flight request is processed by a consistent partition end-to-end
        and none is dropped or recomputed.  Blocks until the tail collector
        completes the final barrier (or ``timeout``).

        The fence rides FIFO channels, so it cannot be lost: an
        un-acknowledged return (``acknowledged: False``) means the marker
        is still behind a backlog, not that the migration failed — the
        replicas WILL adopt the committed cuts when it clears, which is why
        ``partition``/``epoch`` are updated to the committed target either
        way.  Callers treat un-acked as migration-in-progress (the
        controller skips its post-swap precompile and rebaselines its
        telemetry window).

        Returns a summary record (also appended to ``reconfig_records``).
        """
        assert self._configured and self._params is not None, \
            "configure() before reconfigure()"
        assert self._started, "reconfigure() fences a running chain"
        with self._reconfig_lock:
            new_bounds = [0, *sorted(int(c) for c in cuts),
                          len(self.graph.nodes)]
            new_ranges = list(zip(new_bounds, new_bounds[1:]))
            old_ranges = [tuple(r) for r in self.partition.ranges()]
            if len(new_ranges) != len(self.stages):
                raise ValueError(
                    f"cuts {tuple(cuts)} give {len(new_ranges)} stages for "
                    f"{len(self.stages)} stages")
            if any(hi <= lo for lo, hi in new_ranges):
                raise ValueError(f"cuts {tuple(cuts)} leave an empty stage")
            if [tuple(r) for r in new_ranges] == old_ranges:
                return {"epoch": self.epoch, "changed": False}

            epoch = self.epoch + 1
            plans: dict[int, NodePlan] = {}
            shipped = 0
            moved_layers = 0
            for i, ((lo, hi), (lo2, hi2)) in enumerate(
                    zip(old_ranges, new_ranges)):
                if (lo, hi) == (lo2, hi2):
                    continue               # untouched stage: no plan, no bytes
                names = [n.name for n in self.graph.slice_nodes(lo2, hi2)]
                kept = {n.name for n in self.graph.slice_nodes(lo, hi)}
                gained = [nm for nm in names if nm not in kept]
                moved_layers += len(gained)
                spec = {"layers": names,
                        "next": i + 1 if i + 1 < len(self.stages) else None}
                arch_blob = json.dumps(spec).encode()
                weights_blob = b""
                if gained:
                    weights_blob, rec = self.codecs.weights.encode_tree(
                        {nm: self._params[nm] for nm in gained}, "weights")
                    self.config_records.append(rec)
                plans[i] = NodePlan(lo2, hi2, arch_blob, weights_blob,
                                    self.codecs.weights,
                                    wire_bytes=len(arch_blob)
                                    + len(weights_blob))
                # the diff travels once per REPLICA of the stage
                shipped += plans[i].wire_bytes * len(
                    self.stages[i].live_replicas())

            ev = threading.Event()
            self._reconfig_expect = epoch
            self._reconfig_event = ev
            t0 = time.perf_counter()
            # the fence enters the first stage's router like any envelope
            # and stays ordered behind everything already pumped
            self._stage_inputs[0].send(ReconfigMarker(epoch, plans))
            acked = ev.wait(timeout)
            self._reconfig_event = None
            # a repartition invalidates per-stage KV caches (they are keyed
            # by the stage's layer slice, which just moved): every active
            # decode session is displaced — the generate loop re-prefills
            # from its retained history, so sessions survive the move
            with self._lock:
                self._displaced_sessions.update(self._active_sessions)
            self.topology = self.topology.with_layers(new_bounds)
            self.partition = partition(self.graph, len(self.stages),
                                       link=self.link, cuts=new_bounds[1:-1],
                                       replicas=self.replicas)
            self.epoch = epoch
            record = {
                "epoch": epoch, "changed": True, "acknowledged": acked,
                "cuts": tuple(new_bounds[1:-1]),
                "moved_layers": moved_layers,
                "shipped_bytes": shipped,
                "migrate_s": time.perf_counter() - t0,
                "nodes_touched": sorted(plans),
            }
            self.reconfig_records.append(record)
            return record

    # -- elastic membership (spawn / drain replicas) ---------------------------
    def scale(self, stage: int, replicas: int,
              timeout: float | None = 60.0,
              precompile: bool = False) -> dict:
        """Grow or shrink one stage's replica count on the RUNNING chain.

        Spawn (``replicas`` > current): fresh :class:`ComputeNode`
        replicas are built, configured over the wire with the stage's full
        weights, and started; the epoch fence then adds them to the
        stage's routing set — they only ever see post-fence work, so no
        request straddles the membership change.

        Drain (``replicas`` < current): the fence removes the
        highest-numbered replicas from the routing set; each draining
        replica still receives the fence (flushing everything already
        routed to it, which the downstream barrier then accounts for) and
        a trailing retire token, after which its threads exit without
        signaling downstream.  Zero requests are dropped, duplicated, or
        reordered per client.

        Blocks until the collector acknowledges the fence (or
        ``timeout``); un-acked means fence-in-flight, exactly as for
        :meth:`reconfigure`.  ``precompile=True`` traces spawned replicas'
        batch shapes before they join (no first-call cost inside a serving
        window, at the cost of a slower scale-up).
        """
        assert self._configured and self._params is not None, \
            "configure() before scale()"
        assert self._started, "scale() fences a running chain"
        if not 0 <= stage < len(self.stages):
            raise ValueError(f"no stage {stage} in a "
                             f"{len(self.stages)}-stage topology")
        if replicas < 1:
            raise ValueError("a stage needs at least one replica")
        with self._reconfig_lock:
            group = self.stages[stage]
            # a replica drained by an earlier un-acked scale stays listed
            # while it flushes (telemetry/knobs/shutdown must see it);
            # live_replicas() prunes it once its threads exit
            live = [r for r in group.live_replicas() if not r.retiring]
            cur = len(live)
            if replicas == cur:
                return {"epoch": self.epoch, "changed": False,
                        "stage": stage, "replicas": cur}
            epoch = self.epoch + 1
            adds: list[ComputeNode] = []
            drops: list[ComputeNode] = []
            shipped = 0
            t0 = time.perf_counter()
            if replicas > cur:
                lo, hi = self.partition.ranges()[stage]
                arch_blob, weights_blob = self._stage_blobs(stage, lo, hi)
                next_r = max((n.replica for n in group.replicas),
                             default=-1) + 1
                nxt = (self._stage_inputs[stage + 1]
                       if stage + 1 < len(self.stages)
                       else self.result_channel)
                # inherit the stage's LIVE knobs, not the spec defaults:
                # the controller tunes knobs uniformly per stage and
                # compares against replica 0's values, so a default-knobbed
                # newcomer would never be corrected.  A stage whose every
                # replica crashed (supervisor respawn-from-zero) has no
                # live reference; newcomers then keep spec defaults.
                ref = live[0] if live else None
                for k in range(replicas - cur):
                    node = self._make_replica(stage, next_r + k)
                    if ref is not None:
                        node.max_batch = ref.max_batch
                        node.coalesce_s = ref.coalesce_s
                    node.configure(self.graph, lo, hi, arch_blob,
                                   weights_blob, self.codecs.weights)
                    node.next_inbox = nxt
                    if precompile:
                        node.precompile()
                    node.start()
                    adds.append(node)
                    shipped += len(arch_blob) + len(weights_blob)
            else:
                drops = live[replicas:]
            group.stage_membership(epoch, adds, drops)
            group.replicas.extend(adds)     # stats/report see them at once
            for node in drops:
                node.retiring = True

            ev = threading.Event()
            self._reconfig_expect = epoch
            self._reconfig_event = ev
            self._stage_inputs[0].send(ReconfigMarker(epoch, {}))
            acked = ev.wait(timeout)
            self._reconfig_event = None
            self.epoch = epoch
            if acked:
                # fence cleared chain-wide: the drops flushed everything
                # and their threads are exiting — join, then prune.
                # Un-acked drops stay visible until they exit (pruned by
                # any live_replicas() reader; shutdown joins them too).
                for node in drops:
                    node.join()
                group.live_replicas()
            self.topology = self.topology.with_replicas(stage, replicas)
            self.partition = partition(
                self.graph, len(self.stages), link=self.link,
                cuts=list(self.partition.cuts) or None,
                replicas=self.replicas)
            record = {
                "epoch": epoch, "changed": True, "acknowledged": acked,
                "kind": "scale", "stage": stage,
                "replicas_before": cur, "replicas_after": replicas,
                "spawned": len(adds), "retired": len(drops),
                "shipped_bytes": shipped,
                "scale_s": time.perf_counter() - t0,
            }
            self.reconfig_records.append(record)
            return record

    def set_stage_knobs(self, stage: int, max_batch: int | None = None,
                        coalesce_s: float | None = None) -> None:
        """Retune one stage's serving knobs live (controller's actuator),
        uniformly across its replicas.  ``max_batch`` is clamped to
        [1, max_batch_cap] so precompiled batch specializations stay
        authoritative."""
        for node in self.stages[stage].replicas:
            if max_batch is not None:
                node.max_batch = min(max(1, int(max_batch)),
                                     node.max_batch_cap)
            if coalesce_s is not None:
                node.coalesce_s = max(0.0, float(coalesce_s))

    # -- teardown ---------------------------------------------------------------
    def drain(self, timeout: float | None = None) -> bool:
        """Block until no request is in flight.  True if drained."""
        with self._idle:
            return self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)

    def reset_stats(self) -> None:
        with self._lock:
            self.latencies = []
            self.feed_records = []
        for node in self.nodes:
            node.reset_stats()

    # how long a router (or the collector) whose upstream is joined may
    # take to reach its stop count before shutdown tops it up
    _STOP_TOPUP_S = 0.5

    def _join_stopped(self, thread: threading.Thread | None,
                      channel: Channel) -> None:
        """Join a stage's router (or the collector) once every replica
        upstream of it has been joined.  A replica severed at its join (a
        wedged worker process) never forwarded the _STOP it was sent, and
        the thread would wait for that copy forever; so while it lives,
        append _STOP copies to its input.  Everything the upstream ever
        flushed is already queued ahead of them, so a copy cannot overtake
        anything, and copies it does not need are never read."""
        if thread is None:
            return
        thread.join(self._STOP_TOPUP_S)
        while thread.is_alive():
            try:
                channel.send(_STOP)
            except (ChannelClosed, OSError):
                pass            # input link dead: the thread exits on its own
            thread.join(self._STOP_TOPUP_S)

    def shutdown(self, drain: bool = True,
                 timeout: float | None = None) -> None:
        """Stop accepting requests; by default let in-flight ones finish.

        The _STOP token trails every admitted envelope through the FIFO
        channels — each router broadcasts it to its replicas after
        receiving one copy per upstream replica — so even ``drain=False``
        completes (not cancels) in-flight requests; drain merely waits for
        the results before teardown.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if not self._started:
            return
        # never let _STOP overtake a request that already passed the closed
        # check but has not reached the admission queue yet
        with self._idle:
            self._idle.wait_for(lambda: self._admitting == 0,
                                timeout=timeout)
        if drain:
            self.drain(timeout=timeout)
        self.admission.put(_STOP)
        if self._pump_thread:
            self._pump_thread.join()
        for group in self.stages:
            self._join_stopped(group.thread, group.input)
            for node in list(group.replicas):   # incl. flushing retirees
                node.join()
        if self._collect_thread:
            self._join_stopped(self._collect_thread, self.result_channel)
        # the reaper outlives the drain (it must be able to fail pending
        # deadline/replay events during it); stop it after the collector
        with self._lock:
            self._reaper_stop = True
            self._timer_cv.notify_all()
        if self._reaper_thread:
            self._reaper_thread.join()
        # every thread is down: release the channels (sockets, link
        # clocks) and return them to their transports' live counts
        for ch in self._channels:
            try:
                ch.close()
            except Exception:  # deferlint: swallow(best-effort teardown of already-dead channels)
                pass
