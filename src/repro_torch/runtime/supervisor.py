"""Self-healing process-per-replica supervision.

The twin of ``repro.runtime.supervisor``.  The :class:`Supervisor` plugs
into the dispatcher's ``replica_factory`` hook: every replica the engine
builds — at construction AND through the
:meth:`~repro_torch.runtime.dispatcher.Dispatcher.scale` spawn path —
becomes a :class:`WorkerHandle` fronting a real OS process running
``python -m repro_torch.runtime.worker``.  The handle duck-types
:class:`~repro_torch.runtime.node.ComputeNode` completely (configure /
precompile / start / retire / join, knobs, snapshot, trace telemetry,
``device``), so the dispatcher, routers, controller, and engine report
code are unchanged: a stage may be process-backed or in-process and
nothing upstream can tell.

Every worker computes on the engine's device (``Dispatcher.device``,
shipped in the ``"config"`` frame), so on a card each worker is one CUDA
context of its own beside the parent's.  On an NVIDIA H100 80GB HBM3
(700 W, torch 2.11, CUDA 12.8) a bare context with torch loaded takes
618 MiB of device memory, and a worker serving one stage of ResNet50 at
224x224 (its weights, activations and cuDNN workspaces) about 790 MiB:
``chip_smoke.py``'s ``procs`` phase reads both.  A worker inherits the
parent's environment (``CUDA_VISIBLE_DEVICES`` included) plus
``SupervisorConfig.env``; nothing here picks a card.

Wiring per worker (all on loopback, all byte-framed, no pickle):

* a **control socket** the worker dials at launch (token handshake) —
  carries the config handoff (graph factory name + a
  :class:`~repro_torch.runtime.wire.NodePlan` with architecture + weights, the
  same framing a live repartition ships), knob updates, periodic
  ``"hb"`` heartbeats with the node's snapshot, and the clean ``"bye"``;
* two **data channels** completed against the supervisor's private
  :class:`~repro_torch.runtime.transport.TcpTransport` listener
  (:meth:`~repro_torch.runtime.transport.TcpTransport.expect_channel` /
  :func:`~repro_torch.runtime.transport.dial_channel`): the worker's inbox
  (router -> worker) and its egress stream (worker -> relay thread ->
  next stage's input), with the credit-window backpressure contract
  intact across the process boundary.

Failure detection is layered: OS child reaping (``poll``), heartbeat age
(a dead or wedged *process*), and optional stall detection (heartbeats
flowing but the snapshot frozen with a backlog — a hung compute thread,
which heartbeat-age alone must NOT page on since the heartbeat thread is
healthy).  On a crash the monitor reuses the elastic heal path end to
end: sever the dead worker's channels (the routers' ``probe_members``
then retires it and fails exactly the stranded batches), nudge a
zero-extent envelope through the chain so even an idle router probes,
and respawn through ``dispatcher.scale`` (with ``precompile``, so a
respawned replica warms its batch shapes before it serves) with
exponential backoff under a bounded per-stage budget.  When the budget
is exhausted the stage **degrades** to its surviving replicas — the
chain keeps serving — and a quiet period (``stable_s``) refunds the
budget.

``Supervisor.close()`` reaps every child it ever spawned (terminate ->
kill escalation), so no test or benchmark run can leak orphan processes.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import torch

from repro_torch.runtime.node import BatchTrace
from repro_torch.runtime.transport import (ChannelClosed, TcpTransport,
                                           recv_framed, send_framed)
from repro_torch.runtime.wire import (_RETIRE, _STOP, BatchEnvelope,
                                      ControlFrame, NodePlan, ReconfigMarker,
                                      WireFormatError)


@dataclasses.dataclass
class SupervisorConfig:
    """Knobs for process supervision.

    ``graph_factory`` names how a *worker* rebuilds the layer graph
    locally: ``"pkg.module:fn"`` or ``"/path/to/file.py:fn"``, called as
    ``fn(**graph_args)`` — layer code is pre-installed on every node (the
    paper's deployment model); only topology and weights travel."""

    graph_factory: str
    graph_args: dict = dataclasses.field(default_factory=dict)
    heartbeat_s: float = 0.5            # worker hb period
    heartbeat_timeout_s: float = 5.0    # no hb this long -> declared dead
    stall_timeout_s: float | None = None    # hb alive but frozen + backlog
    spawn_timeout_s: float = 60.0       # hello/ready deadline per worker
    shutdown_grace_s: float = 10.0      # join/reap patience per worker
    backoff_initial_s: float = 0.25     # respawn backoff ladder
    backoff_max_s: float = 5.0
    backoff_factor: float = 2.0
    respawn_budget: int = 3             # per-stage crash allowance
    stable_s: float = 30.0              # quiet period refunding the budget
    allow_chaos: bool = False           # spawn workers with --chaos
    env: dict = dataclasses.field(default_factory=dict)
    python: str | None = None           # worker interpreter; None = ours


class WorkerHandle:
    """Supervisor-side stand-in for one process-backed replica.

    Stands in for a :class:`~repro_torch.runtime.node.ComputeNode` in
    everything the dispatcher, routers, controller, and engine report
    touch: its identity (``index``, ``replica``, ``device``, ``epoch``,
    ``retiring``, ``_nodes``, ``config_records``), its channels, its knobs
    (``max_batch``, ``max_batch_cap``, ``coalesce_s``), its window
    telemetry (``traces``, ``queue_depths``, the ``busy_*_s`` under
    ``_stats_lock``, ``snapshot()``, ``reset_stats()``: rebuilt from
    heartbeats) and its lifecycle (``configure``, ``precompile``,
    ``start``, ``retire``, ``join``, ``_threads``).  The heartbeats carry
    none of the node's decode counters, so ``window_report()`` returns
    none.

    Its ``inbox`` is the send half of the worker's inbox channel
    (so router sends cross the socket), and a relay thread forwards the
    worker's egress stream into ``next_inbox`` — the one ComputeNode duty
    that must live supervisor-side, because the worker cannot reach the
    next stage's in-process channel directly.

    ``lost_on_death = True`` widens the router's heal path: a killed
    process loses batches it had already *consumed* (they were inside
    its pipeline), so the whole in-flight ledger fails, not just the
    channel's unconsumed tail.  Entries whose results already reached
    the collector resolve to no-ops there — at-most-once, never a hang.

    ``device`` is the engine's (what the worker is told to compute on);
    ``worker_device``, ``launches`` and ``plain_calls`` are what the
    worker last reported in ``"ready"`` / ``"hb"``: its node's device and
    its block-quant wrapper's kernel launches and plain-version calls,
    by kernel.
    ``spawned_at`` / ``ready_at`` (monotonic) bound its start-up.
    """

    lost_on_death = True

    def __init__(self, sup: "Supervisor", stage: int, replica: int,
                 inbox, outbox, in_cid: int, out_cid: int,
                 capacity: int, token: str, spec, codec, device):
        self._sup = sup
        self.index = stage
        self.replica = replica
        self.inbox = inbox              # send half: router -> worker
        self._outbox = outbox           # recv half: worker -> relay
        self._in_cid = in_cid
        self._out_cid = out_cid
        self._capacity = capacity
        self.token = token
        self._spec = spec               # the stage's StageSpec
        self._data_codec = codec
        self.device = device
        self.worker_device: str | None = None
        self.launches: dict[str, int] = {}
        self.plain_calls: dict[str, int] = {}
        self.spawned_at: float | None = None
        self.ready_at: float | None = None
        self.retiring = False
        self.dead = False
        self.bye = False
        self.drained = False    # its egress forwarded _STOP
        self.epoch = 0
        self.max_batch_cap = 1          # finalized in _spawn, like the knobs
        self._max_batch = 1
        self._coalesce_s = 0.005
        self._configured = False
        self._started_flag = False
        self.proc: subprocess.Popen | None = None
        self._csock: socket.socket | None = None
        self._send_lock = threading.Lock()
        self._hello = threading.Event()
        self._ready = threading.Event()
        self._creader: threading.Thread | None = None
        # telemetry, synthesized from heartbeat snapshot deltas so the
        # engine report and the controller read a worker exactly like an
        # in-process node
        self._stats_lock = threading.Lock()
        self.traces: list[BatchTrace] = []
        self.queue_depths: list[float] = []
        self.busy_decode_s = 0.0
        self.busy_compute_s = 0.0
        self.busy_encode_s = 0.0
        self.config_records: list = []
        self._nodes: list = []
        self._last_snap: dict = {}
        self._base_snap: dict = {}
        self._hb_at: float | None = None
        self._progress_n = -1
        self._progress_at = time.monotonic()
        self._backlog_since: float | None = None    # monitor-thread only
        self._fwd_tokens = 0            # control tokens relayed downstream
        self._relay_thread = threading.Thread(
            target=self._relay_loop, daemon=True,
            name=f"defer-s{self.index}r{self.replica}-relay")
        self._threads = [self._relay_thread]    # live_replicas() prunes on
        self._relay_thread.start()              # these, like a real node
        self.next_inbox = None

    # -- the egress relay ------------------------------------------------------
    def _relay_loop(self) -> None:
        """Worker egress -> next stage's input.  Envelopes, fence markers,
        and the _STOP cascade all pass through untouched, so downstream
        barrier counting sees exactly one copy per upstream replica —
        process-backed or not.  _RETIRE never arrives (the worker's own
        egress exits without forwarding it); a severed socket ends the
        loop without forwarding anything (the router proxies whatever the
        dead member still owed downstream)."""
        while True:
            try:
                item = self._outbox.recv()
            except ChannelClosed:
                return
            if item is _STOP:
                self.drained = True     # the worker flushed: it is leaving
            try:
                if self.next_inbox is not None:
                    self.next_inbox.send(item)
            except (ChannelClosed, OSError):
                if item is _STOP:
                    return
                continue        # downstream gone: its own death path owns it
            if not isinstance(item, BatchEnvelope):
                # count fence/stop copies that actually crossed into the
                # next stage: after a crash the router settles the SENT
                # minus FORWARDED difference so barrier counts stay exact
                self._fwd_tokens += 1
            if item is _STOP:
                return

    def forwarded_tokens(self) -> int:
        """How many control tokens (fence markers, _STOP) the relay has
        pushed downstream.  The router's settle path reads this after the
        member dies — with the relay thread joined, so the count is
        final — to proxy exactly the copies the worker was sent but never
        forwarded (lost in the dead process / its doomed socket buffer)."""
        return self._fwd_tokens

    # -- control plane ---------------------------------------------------------
    def _attach_control(self, conn: socket.socket) -> None:
        self._csock = conn
        self._hb_at = time.monotonic()
        self._creader = threading.Thread(
            target=self._control_loop, daemon=True,
            name=f"defer-s{self.index}r{self.replica}-control")
        self._creader.start()
        self._hello.set()

    def _control_loop(self) -> None:
        sock = self._csock
        while True:
            try:
                item = recv_framed(sock)
            except (WireFormatError, OSError):
                return          # EOF: crash or post-bye close; monitor decides
            if not isinstance(item, ControlFrame):
                continue
            if item.kind == "hb":
                self._on_hb(item.payload)
            elif item.kind == "ready":
                self._hb_at = self.ready_at = time.monotonic()
                self._on_status(item.payload)
                self._ready.set()
            elif item.kind == "bye":
                self.bye = True
                return

    def _control_send(self, item, required: bool = False) -> None:
        sock = self._csock
        if sock is None:
            if required:
                raise ChannelClosed("worker control socket not attached")
            return
        try:
            send_framed(sock, item, lock=self._send_lock)
        except OSError as e:
            if required:
                raise ChannelClosed(f"worker control send failed: {e}") from e

    def _on_status(self, payload: dict) -> None:
        """The port's own fields of ``ready`` / ``hb``; a frame of the
        reference's shape (without them) leaves them as they were."""
        if "device" in payload:
            self.worker_device = payload["device"]
        self.launches = dict(payload.get("launches", self.launches))
        self.plain_calls = dict(payload.get("plain_calls", self.plain_calls))

    def _on_hb(self, payload: dict) -> None:
        snap = payload.get("snapshot") or {}
        self._on_status(payload)

        def g(d: dict, k: str):
            return d.get(k, 0) or 0

        with self._stats_lock:
            self._hb_at = time.monotonic()
            prev, self._last_snap = self._last_snap, snap
            dn = int(g(snap, "n") - g(prev, "n"))
            if dn > 0:
                # one synthetic trace per heartbeat interval: totals
                # (requests, stage seconds, payload) aggregate exactly;
                # only per-wave shape (batch_mean) coarsens to per-interval
                self.traces.append(BatchTrace(
                    self.index, dn, 0,
                    g(snap, "deserialize_s") - g(prev, "deserialize_s"),
                    g(snap, "compute_s") - g(prev, "compute_s"),
                    g(snap, "serialize_s") - g(prev, "serialize_s"),
                    int(g(snap, "payload_bytes") - g(prev, "payload_bytes")),
                    encodes=int(g(snap, "encodes") - g(prev, "encodes"))))
            dc = g(snap, "depth_count") - g(prev, "depth_count")
            if dc > 0:
                self.queue_depths.append(
                    (g(snap, "depth_sum") - g(prev, "depth_sum")) / dc)
            base = self._base_snap
            self.busy_decode_s = g(snap, "busy_decode_s") \
                - g(base, "busy_decode_s")
            self.busy_compute_s = g(snap, "busy_compute_s") \
                - g(base, "busy_compute_s")
            self.busy_encode_s = g(snap, "busy_encode_s") \
                - g(base, "busy_encode_s")
            self.epoch = int(g(snap, "epoch"))
            if dn != 0:
                self._progress_n = int(g(snap, "n"))
                self._progress_at = self._hb_at

    # -- ComputeNode surface ---------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self._max_batch

    @max_batch.setter
    def max_batch(self, v: int) -> None:
        self._max_batch = max(1, int(v))
        self._push_knobs()

    @property
    def coalesce_s(self) -> float:
        return self._coalesce_s

    @coalesce_s.setter
    def coalesce_s(self, v: float) -> None:
        self._coalesce_s = max(0.0, float(v))
        self._push_knobs()

    def _push_knobs(self) -> None:
        if self._configured:
            self._control_send(ControlFrame("knobs", {
                "max_batch": self._max_batch,
                "coalesce_s": self._coalesce_s}))

    def configure(self, graph, lo: int, hi: int, arch_blob: bytes,
                  weights_blob: bytes, weights_codec) -> None:
        """The configuration step, over the control socket: channel
        wiring + codec + knobs ride a ``"config"`` frame, then the
        architecture + weights ship as the standard NodePlan framing."""
        self._await_hello()
        self._nodes = graph.slice_nodes(lo, hi)
        cfg = self._sup._cfg
        host, port = self._sup._transport.address
        c = self._data_codec
        self._control_send(ControlFrame("config", {
            "graph_factory": cfg.graph_factory,
            "graph_args": cfg.graph_args,
            "stage": self.index, "replica": self.replica,
            "data_codec": [c.serializer, c.compression, c.zfp_rate,
                           c.vectorized, c.small_bypass],
            "session_capacity": getattr(self._spec, "session_capacity",
                                        None) or 64,
            "max_batch": self._max_batch,
            "coalesce_s": self._coalesce_s,
            "max_batch_cap": self.max_batch_cap,
            "shape_buckets": self._spec.shape_buckets
            or self._sup._defaults.get("shape_buckets", "exact"),
            "host": host, "port": port,
            "in_cid": self._in_cid, "in_capacity": self._capacity,
            "out_cid": self._out_cid, "out_capacity": self._capacity,
            "heartbeat_s": cfg.heartbeat_s,
            "device": str(self.device),
            # the parent's TF32 choice: a process-backed replica computes
            # as an in-process one would
            "allow_tf32": {
                "cudnn": bool(torch.backends.cudnn.allow_tf32),
                "matmul": bool(torch.backends.cuda.matmul.allow_tf32)},
        }), required=True)
        self._control_send(ReconfigMarker(0, {self.index: NodePlan(
            lo, hi, arch_blob, weights_blob, weights_codec,
            wire_bytes=len(arch_blob) + len(weights_blob))}),
            required=True)
        self._configured = True

    def _await_hello(self) -> None:
        """Complete the spawn: wait for the worker to dial back (failing at
        once if it exits first), and record it.  A stillborn worker's
        registrations are unwound before the raise."""
        try:
            self._wait_alive(self._hello, "dialed back")
        except ChannelClosed:
            self._sup._abort_spawn(self)
            raise
        self._sup._record("spawn", stage=self.index, replica=self.replica,
                          pid=self.proc.pid)

    def precompile(self) -> None:
        # applied before any later control frame (the worker loop is
        # serial); best-effort on a dead socket — the monitor owns deaths
        self._control_send(ControlFrame("precompile"))

    def start(self) -> None:
        if self._started_flag:
            return
        self._control_send(ControlFrame("start"), required=True)
        self._wait_alive(self._ready, "ready")
        self._started_flag = True

    def _wait_alive(self, ev: threading.Event, what: str) -> None:
        """Wait up to ``spawn_timeout_s`` for ``ev``, and fail at once if
        the process exits first (a worker that raised — a missing CUDA,
        a bad graph factory — is not waited on for the whole timeout)."""
        deadline = time.monotonic() + self._sup._cfg.spawn_timeout_s
        while not ev.wait(0.05):
            rc = self.proc.poll()
            if rc is not None:
                raise ChannelClosed(
                    f"worker stage {self.index} replica {self.replica} (pid "
                    f"{self.proc.pid}) exited rc={rc} before {what}")
            if time.monotonic() >= deadline:
                raise ChannelClosed(
                    f"worker stage {self.index} replica {self.replica} (pid "
                    f"{self.proc.pid}) not {what} within "
                    f"{self._sup._cfg.spawn_timeout_s}s")

    def retire(self) -> None:
        self.inbox.send(_RETIRE)

    def reset_stats(self) -> None:
        # local-only: rebaseline against the worker's lifetime counters
        # instead of round-tripping a reset (windowing stays exact)
        with self._stats_lock:
            self._base_snap = self._last_snap
            self.traces = []
            self.queue_depths = []
            self.busy_decode_s = 0.0
            self.busy_compute_s = 0.0
            self.busy_encode_s = 0.0

    def window_report(self) -> tuple[dict, dict]:
        """No decode counters and no queue waits: the worker's heartbeats
        carry none (see ``ComputeNode.window_report``)."""
        return {}, {}

    def snapshot(self) -> dict:
        """Window telemetry (same keys as ComputeNode.snapshot), rebuilt
        from the last heartbeat relative to the reset baseline."""
        with self._stats_lock:
            last, base = self._last_snap, self._base_snap

            def d(k: str):
                return (last.get(k, 0) or 0) - (base.get(k, 0) or 0)

            waves = d("waves")
            depth_count = d("depth_count")
            return {
                "node": self.index, "replica": self.replica,
                "n": d("n"), "compute_s": d("compute_s"),
                "serialize_s": d("serialize_s"),
                "deserialize_s": d("deserialize_s"),
                "payload_bytes": d("payload_bytes"),
                "encodes": d("encodes"),
                "busy_decode_s": self.busy_decode_s,
                "busy_compute_s": self.busy_compute_s,
                "busy_encode_s": self.busy_encode_s,
                "queue_depth_mean": (d("depth_sum") / depth_count
                                     if depth_count else 0.0),
                "batch_mean": (d("n") / waves if waves else 0.0),
                "waves": waves,
                "depth_sum": d("depth_sum"),
                "depth_count": depth_count,
                "max_batch": self._max_batch,
                "coalesce_s": self._coalesce_s,
                "epoch": self.epoch,
                # a gauge, not a window counter: report it as-is
                "inflight_n": last.get("inflight_n", 0) or 0,
            }

    def kill_links(self) -> None:
        """Sever both data channels (the router's ``probe_members`` then
        heals the routing set; the relay thread wakes and exits)."""
        self.inbox.kill()
        self._outbox.kill()

    def reap(self, grace: float = 5.0) -> None:
        """Make sure the child is gone: wait, escalate to terminate, then
        kill.  Every shutdown path funnels through here, so a supervised
        run can never leave an orphan process behind."""
        proc = self.proc
        if proc is None:
            return
        if proc.poll() is None:
            try:
                proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                proc.terminate()
                try:
                    proc.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    def join(self) -> None:
        """Dispatcher-shutdown path: wait for the relay to flush, then
        reap the process.  Bounded — a wedged worker (hung compute, so
        _STOP never flushes) gets its links severed and the process
        forcibly reaped instead of hanging engine shutdown forever (the
        dispatcher then hands the next stage the _STOP it never
        forwarded: ``Dispatcher._join_stopped``)."""
        grace = self._sup._cfg.shutdown_grace_s
        t = self._relay_thread
        if t.is_alive():
            t.join(grace)
            if t.is_alive():
                self.kill_links()
                t.join(1.0)
        self.reap(grace)


class Supervisor:
    """Spawns, watches, heals, and reaps process-per-replica workers.

    Use :func:`supervised_engine`, or wire manually::

        sup = Supervisor(SupervisorConfig(graph_factory="my.models:mlp"))
        eng = InferenceEngine(graph, topology,
                              replica_factory=sup.replica_factory)
        ...
        eng.shutdown(); sup.close()

    Also usable as a context manager (``close`` on exit).  ``events`` is
    the audit trail: every spawn, death (with cause), respawn, degrade,
    and budget refund appends a record dict.
    """

    def __init__(self, config: SupervisorConfig):
        self._cfg = config
        self._transport = TcpTransport()    # private data-plane listener
        self._lock = threading.Lock()
        self._handles: list[WorkerHandle] = []
        self._by_token: dict[str, WorkerHandle] = {}
        self._dispatcher = None
        self._defaults: dict = {}
        self._closing = threading.Event()
        self._monitor: threading.Thread | None = None
        self._respawners: list[threading.Thread] = []
        # per-stage heal state
        self._budget: dict[int, int] = {}
        self._backoff: dict[int, float] = {}
        self._last_death: dict[int, float] = {}
        self._respawning: set[int] = set()
        self.events: list[dict] = []
        # test hook: called with the WorkerHandle right after a spawn
        # completes (used to inject faults during the spawn fence itself)
        self.on_spawned = None
        # control listener: workers dial back here with their spawn token
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            s.listen(64)
        except BaseException:
            s.close()
            raise
        self._csock = s
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="defer-supervisor-accept").start()

    # -- context manager -------------------------------------------------------
    def __enter__(self) -> "Supervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _record(self, kind: str, **fields) -> None:
        with self._lock:
            self.events.append({"kind": kind, **fields})

    # -- the replica factory (dispatcher hook) ---------------------------------
    def replica_factory(self, dispatcher, stage: int,
                        replica: int) -> WorkerHandle:
        """``Dispatcher(replica_factory=...)`` target: spawn one worker
        process for (stage, replica) and hand back its handle."""
        with self._lock:
            self._dispatcher = dispatcher
            self._defaults = dict(dispatcher._defaults)
            self._budget.setdefault(stage, self._cfg.respawn_budget)
            self._backoff.setdefault(stage, self._cfg.backoff_initial_s)
        handle = self._spawn(dispatcher, stage, replica)
        if self._monitor is None:
            self._monitor = threading.Thread(target=self._monitor_loop,
                                             daemon=True,
                                             name="defer-supervisor-monitor")
            self._monitor.start()
        hook = self.on_spawned
        if hook is not None:
            hook(handle)
        return handle

    def _spawn(self, dispatcher, stage: int, replica: int) -> WorkerHandle:
        cfg = self._cfg
        spec = dispatcher.topology.stages[stage]
        capacity = dispatcher._defaults["queue_depth"]
        token = os.urandom(8).hex()
        inbox, in_cid = self._transport.expect_channel(capacity, role="send")
        try:
            outbox, out_cid = self._transport.expect_channel(capacity,
                                                             role="recv")
        except BaseException:
            # the first half-channel must not stay registered forever: a
            # late dial with its cid would wire a connection onto a
            # channel no handle owns
            inbox.close()
            self._transport.unexpect_channel(in_cid)
            raise
        try:
            handle = WorkerHandle(self, stage, replica, inbox, outbox,
                                  in_cid, out_cid, capacity, token, spec,
                                  dispatcher.codecs.data, dispatcher.device)
        except BaseException:
            inbox.close()
            outbox.close()
            self._transport.unexpect_channel(in_cid)
            self._transport.unexpect_channel(out_cid)
            raise
        handle._max_batch = spec.max_batch \
            or dispatcher._defaults["max_batch"]
        handle.max_batch_cap = max(
            handle._max_batch,
            spec.max_batch_cap or dispatcher._defaults["max_batch_cap"] or 0)
        if spec.coalesce_s is not None:
            handle._coalesce_s = spec.coalesce_s
        with self._lock:
            self._by_token[token] = handle
            self._handles.append(handle)
        host, port = self._csock.getsockname()
        import repro_torch
        # the import root of this package, so spawned workers import the
        # same copy of it
        src = os.path.dirname(os.path.dirname(
            os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env.update(cfg.env)
        cmd = [cfg.python or sys.executable, "-m",
               "repro_torch.runtime.worker",
               "--connect", f"{host}:{port}", "--token", token]
        if cfg.allow_chaos:
            cmd.append("--chaos")
        try:
            handle.spawned_at = time.monotonic()
            handle.proc = subprocess.Popen(cmd, env=env)
        except BaseException:
            # exec failure (bad interpreter path, fork limits): unwind the
            # registrations exactly like a stillborn worker
            self._abort_spawn(handle)
            raise
        # the worker's dial-back is awaited in configure(), the first use
        # of its control socket: the dispatcher builds every replica
        # before it configures any, so the workers import torch (and
        # start their runtimes) side by side, not one after another
        return handle

    def _abort_spawn(self, handle: WorkerHandle) -> None:
        """Unwind everything a failed spawn registered: pending
        half-channels, data links, the child (if any), the token slot."""
        self._transport.unexpect_channel(handle._in_cid)
        self._transport.unexpect_channel(handle._out_cid)
        handle.dead = True
        handle.retiring = True
        handle.kill_links()
        handle.reap(1.0)
        with self._lock:
            self._by_token.pop(handle.token, None)

    # -- control-plane accept ---------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._csock.accept()
            except OSError:
                return
            try:
                # same half-open-hello guard as the data-plane listener: a
                # client that stalls mid-hello is dropped, not waited on
                conn.settimeout(self._transport.handshake_timeout_s)
                hello = recv_framed(conn)
                conn.settimeout(None)
            except (OSError, ConnectionError, WireFormatError):
                conn.close()
                continue
            token = ""
            if isinstance(hello, ControlFrame) and hello.kind == "hello":
                token = hello.payload.get("token", "")
            with self._lock:
                handle = self._by_token.get(token)
            if handle is None or handle._csock is not None:
                conn.close()
                continue
            handle._attach_control(conn)

    # -- failure detection ------------------------------------------------------
    def _monitor_loop(self) -> None:
        tick = max(0.05, self._cfg.heartbeat_s / 2)
        while not self._closing.wait(tick):
            self._sweep()

    def _sweep(self) -> None:
        cfg = self._cfg
        now = time.monotonic()
        with self._lock:
            handles = list(self._handles)
        for h in handles:
            if h.dead or h.proc is None:
                continue
            rc = h.proc.poll()
            if rc is not None:
                # exited: give the control reader a moment to deliver a
                # racing "bye" (the socket FIFO puts bye before EOF, so a
                # drained worker's bye is never misread as a crash)
                t = h._creader
                if t is not None:
                    t.join(1.0)
                if h.bye or h.retiring or self._closing.is_set():
                    h.dead = True
                    self._record("exit", stage=h.index, replica=h.replica,
                                 rc=rc)
                    continue
                self._on_death(h, f"process exited rc={rc}")
                continue
            if not h._started_flag or h.drained or h.bye:
                # a drained worker closes its links and stops its
                # heartbeat before it leaves the process table (releasing
                # a CUDA context takes a while): its exit is clean, and
                # the branch above records it once the process is gone
                continue
            if (h.inbox.dead or h._outbox.dead) and not h.retiring:
                # data path severed while the process lives (flaky link):
                # the routers already failed over; the worker is
                # unreachable, so retire the orphan and respawn
                h.proc.kill()
                self._on_death(h, "data link severed")
                continue
            hb_at = h._hb_at
            if hb_at is not None and now - hb_at > cfg.heartbeat_timeout_s:
                h.proc.kill()
                self._on_death(h, "heartbeat timeout "
                               f"({cfg.heartbeat_timeout_s}s)")
                continue
            if cfg.stall_timeout_s is not None:
                with h._stats_lock:
                    # unconsumed channel items PLUS work trapped inside
                    # the worker's pipeline (the heartbeat's inflight
                    # gauge) — a wedged compute thread that swallowed its
                    # whole backlog shows qsize 0, credits long returned
                    backlog = h.inbox.qsize() \
                        + (h._last_snap.get("inflight_n", 0) or 0)
                    progress_at = h._progress_at
                if backlog <= 0:
                    h._backlog_since = None
                    continue
                # the stall clock starts with the later of the last
                # progress and the first sweep that saw this backlog: an
                # idle worker's snapshot is frozen legitimately (a fresh
                # spawn has made no progress at all), and its first
                # request must not read as seconds of stall
                if h._backlog_since is None:
                    h._backlog_since = now
                stuck_since = max(progress_at, h._backlog_since)
                if now - stuck_since > cfg.stall_timeout_s:
                    h.proc.kill()
                    self._on_death(h, "stalled: heartbeats flowing but no "
                                   f"progress for {cfg.stall_timeout_s}s "
                                   f"with {backlog} queued")
                    continue
        # a quiet stage earns its crash budget back
        for stage, at in list(self._last_death.items()):
            if now - at > cfg.stable_s \
                    and self._budget.get(stage, 0) < cfg.respawn_budget:
                self._budget[stage] = cfg.respawn_budget
                self._backoff[stage] = cfg.backoff_initial_s
                self._record("budget_refund", stage=stage)
                self._last_death.pop(stage, None)

    # -- the heal path ----------------------------------------------------------
    def _on_death(self, h: WorkerHandle, why: str) -> None:
        h.dead = True
        h.retiring = True       # live_replicas() prunes once the relay exits
        h.kill_links()          # routers probe .dead and heal + fail stranded
        with self._lock:
            self._by_token.pop(h.token, None)
        h.reap(1.0)
        self._record("death", stage=h.index, replica=h.replica, why=why)
        self._last_death[h.index] = time.monotonic()
        self._nudge()
        d = self._dispatcher
        if (self._closing.is_set() or d is None or d._closed
                or not d._started):
            return
        with self._lock:
            if h.index in self._respawning:
                return          # an active respawner will see the deficit
            self._respawning.add(h.index)
        t = threading.Thread(target=self._respawn_loop, args=(h.index,),
                             daemon=True,
                             name=f"defer-supervisor-respawn-s{h.index}")
        with self._lock:
            self._respawners.append(t)
        t.start()

    def _nudge(self) -> None:
        """Push one zero-extent error envelope through the chain so every
        stage's router runs its dead-member probe even when the chain is
        idle (all clients blocked on stranded futures, nothing arriving
        to trigger a probe).  The envelope resolves to a no-op at the
        collector (no extents, no futures)."""
        d = self._dispatcher
        if d is None or d._closed or not d._started:
            return

        def poke() -> None:
            try:
                d._stage_inputs[0].send(BatchEnvelope(
                    [], b"", error="supervisor probe (a worker died)"))
            except (ChannelClosed, OSError):
                pass        # head link gone: the chain is already failing over

        # fire-and-forget: the head channel is bounded, and the monitor
        # must never block behind a backlogged chain
        threading.Thread(target=poke, daemon=True,
                         name="defer-supervisor-probe").start()

    def _respawn_loop(self, stage: int) -> None:
        """Re-grow ``stage`` to its topology target through the standard
        ``dispatcher.scale`` spawn path, with exponential backoff, until
        healed / budget exhausted / closing."""
        cfg = self._cfg
        try:
            while not self._closing.is_set():
                d = self._dispatcher
                if d is None or d._closed:
                    return
                target = d.topology.stages[stage].replicas
                live = len([r for r in d.stages[stage].live_replicas()
                            if not r.retiring])
                if live >= target:
                    return
                with self._lock:
                    if self._budget.get(stage, 0) <= 0:
                        degraded = True
                    else:
                        degraded = False
                        self._budget[stage] -= 1
                if degraded:
                    self._record("degraded", stage=stage, surviving=live,
                                 target=target)
                    return
                delay = self._backoff.get(stage, cfg.backoff_initial_s)
                self._backoff[stage] = min(delay * cfg.backoff_factor,
                                           cfg.backoff_max_s)
                if self._closing.wait(delay):
                    return
                try:
                    rec = d.scale(stage, target, precompile=True)
                    self._record("respawn", stage=stage, target=target,
                                 epoch=rec.get("epoch"))
                except Exception as e:  # deferlint: swallow(respawn retries with backoff; failure recorded in events)
                    self._record("respawn_failed", stage=stage,
                                 error=repr(e))
        finally:
            with self._lock:
                self._respawning.discard(stage)

    # -- teardown ---------------------------------------------------------------
    def close(self) -> None:
        """Stop monitoring and reap every child ever spawned.  Call after
        ``engine.shutdown()`` — a supervised run must end with zero
        orphan processes and zero lingering respawners."""
        self._closing.set()
        if self._monitor is not None:
            self._monitor.join(self._cfg.shutdown_grace_s)
        with self._lock:
            respawners = list(self._respawners)
            handles = list(self._handles)
        for t in respawners:
            t.join(self._cfg.shutdown_grace_s)
        for h in handles:
            h.kill_links()
            h.reap(self._cfg.shutdown_grace_s)
            t = h._relay_thread
            t.join(1.0)
        try:
            self._csock.close()
        except OSError:
            pass
        self._transport.close()


def supervised_engine(graph, params, topology, config: SupervisorConfig,
                      **engine_kw):
    """Build a configured :class:`~repro_torch.runtime.engine.InferenceEngine`
    whose replicas are supervised worker processes.  Returns
    ``(engine, supervisor)``; shut down the engine first, then
    ``supervisor.close()``.  ``engine_kw`` may name the ``device`` every
    worker computes on."""
    from repro_torch.runtime.engine import InferenceEngine
    sup = Supervisor(config)
    try:
        eng = InferenceEngine(graph, topology,
                              replica_factory=sup.replica_factory,
                              **engine_kw)
        eng.configure(params)
    except BaseException:
        sup.close()
        raise
    return eng, sup
