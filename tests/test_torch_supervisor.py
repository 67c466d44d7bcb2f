"""The port's process-per-replica supervision on the CPU: the quick legs of
``tests/test_supervisor.py`` on ``repro_torch`` (framed control streams,
cross-process channel completion, the half-open-hello accept guard,
graph-factory resolution, spawn-failure cleanup, an end-to-end smoke and
a kill that heals), plus what only the port has to show: control frames
that cross between the packages byte for byte, the worker's and the
supervisor's verbs in step, a process-backed chain bit for bit equal to
the in-process engine and within 1e-5 of the JAX package, the worker's
device and kernel counters in its heartbeats, and a worker told to use a
CUDA the machine lacks failing loudly.

``test_control_frame_roundtrip_is_version_4`` has no twin here: the
port's ``ControlFrame`` at ``FRAME_VERSION`` 4, nested payload included,
is held byte for byte against the reference's in
``tests/test_torch_wire.py::test_frame_bytes_identical`` and
``::test_frames_cross_between_packages``.

Every engine computes on the CPU (``device="cpu"``), and workers get
``OMP_NUM_THREADS=1`` through ``SupervisorConfig.env``.  The long chaos
drills live in ``tests/test_torch_chaos.py``.
"""
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import wire as jw
from repro_torch.core.graph import LayerGraph
from repro_torch.runtime import (InferenceEngine, TopologySpec,
                                 supervised_engine)
from repro_torch.runtime import wire as tw
from repro_torch.runtime.dispatcher import DeadlineExceeded, DispatcherCodecs
from repro_torch.runtime.node import ComputeNode
from repro_torch.runtime.supervisor import (Supervisor, SupervisorConfig,
                                            WorkerHandle)
from repro_torch.runtime.transport import (ChannelClosed, TcpTransport,
                                           dial_channel, recv_framed,
                                           send_framed)
from repro_torch.runtime.wire import (BatchEnvelope, ControlFrame, RowExtent,
                                      WireCodec)
from repro_torch.runtime.worker import load_graph_factory
from tests import _worker_graphs as jgraphs
from tests._torch_worker_graphs import mlp_graph
from tools.torch_chaos import Chaos

torch.set_num_threads(1)

GRAPHS = os.path.join(os.path.dirname(__file__), "_torch_worker_graphs.py")
RAW = DispatcherCodecs(data=WireCodec("raw", "none"),
                       weights=WireCodec("raw", "none"))
ROOT = os.path.join(os.path.dirname(__file__), "..")


def _cfg(**kw):
    kw.setdefault("graph_factory", GRAPHS + ":mlp_graph")
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("heartbeat_timeout_s", 5.0)
    kw.setdefault("backoff_initial_s", 0.1)
    kw.setdefault("backoff_max_s", 0.5)
    kw.setdefault("spawn_timeout_s", 60.0)
    kw.setdefault("shutdown_grace_s", 5.0)
    kw.setdefault("env", {"OMP_NUM_THREADS": "1"})
    return SupervisorConfig(**kw)


def _ref(g: LayerGraph, params):
    """x -> the port's single-device apply on the CPU."""
    prep = g.prepare(params, "cpu")
    return lambda x: g.apply(prep, torch.from_numpy(x)).numpy()


def _xs(n: int, d: int = 16) -> list:
    return [np.random.default_rng(i).normal(size=(1, d)).astype(np.float32)
            for i in range(n)]


# -- ControlFrame on the wire -------------------------------------------------

def test_control_frame_framed_stream_roundtrip():
    a, b = socket.socketpair()
    try:
        send_framed(a, ControlFrame("hello", {"token": "t0", "pid": 42}))
        got = recv_framed(b)
        assert got.kind == "hello" and got.payload["pid"] == 42
    finally:
        a.close()
        b.close()


# every verb either package's supervisor or worker sends, with the
# reference's payload and, for ready / hb, the port's wider one
_SNAP = {"node": 1, "replica": 0, "n": 3, "compute_s": 0.5,
         "inflight_n": 2, "nested": [1, (2, 3), None]}
_VERBS = [
    ("hello", {"token": "ab12", "pid": 42}),
    ("config", {"graph_factory": "m:f", "graph_args": {"batch": 1},
                "stage": 0, "replica": 1,
                "data_codec": ["q8", "none", 16, True, 0],
                "host": "127.0.0.1", "port": 5, "heartbeat_s": 0.1}),
    ("config", {"graph_factory": "m:f", "graph_args": {}, "stage": 2,
                "replica": 0, "data_codec": ["raw", "none", 16, True, 0],
                "device": "cuda:0"}),
    ("precompile", {}), ("start", {}), ("bye", {}),
    ("knobs", {"max_batch": 4, "coalesce_s": 0.005}),
    ("chaos", {"action": "slow_compute", "delay_s": 0.05}),
    ("ready", {"pid": 42}),
    ("ready", {"pid": 42, "device": "cuda:0",
               "launches": {"quantize_blocks": 6, "dequantize_blocks": 6},
               "plain_calls": {"quantize_blocks": 0,
                               "dequantize_blocks": 0}}),
    ("hb", {"snapshot": _SNAP}),
    ("hb", {"snapshot": _SNAP, "device": "cpu",
            "launches": {"quantize_blocks": 0, "dequantize_blocks": 0},
            "plain_calls": {"quantize_blocks": 4, "dequantize_blocks": 3}}),
]


@pytest.mark.parametrize("kind,payload", _VERBS,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(_VERBS)])
def test_control_frames_cross_between_packages(kind, payload):
    """A control frame framed by either package has the same bytes, and
    each package decodes the other's — the port's wider ready / hb
    payloads included."""
    port_blob = tw.frame(tw.ControlFrame(kind, payload))
    ref_blob = jw.frame(jw.ControlFrame(kind, payload))
    assert port_blob == ref_blob
    back_t, back_j = tw.unframe(ref_blob), jw.unframe(port_blob)
    assert isinstance(back_t, tw.ControlFrame)
    assert isinstance(back_j, jw.ControlFrame)
    assert back_t.kind == back_j.kind == kind
    assert back_t.payload == back_j.payload
    assert tw.frame(back_t) == port_blob


def test_control_verbs_match_between_worker_and_supervisor():
    """DL604 on the port's pair: every verb the supervisor sends the worker
    handles, and the reverse (``chaos`` comes from the chaos harness,
    marked at its anchor).  The repo's linter pairs only the first
    supervisor / worker it finds, the reference's, so this test holds the
    port's."""
    from tools.deferlint.core import load_module
    from tools.deferlint.protocol import (CONTROL_RE, _control_handles,
                                          _control_sends)
    rt = os.path.join(ROOT, "src", "repro_torch", "runtime")
    sup = load_module(os.path.join(rt, "supervisor.py"), ROOT)
    wrk = load_module(os.path.join(rt, "worker.py"), ROOT)
    for sender, handler in ((sup, wrk), (wrk, sup)):
        sends, handles = _control_sends(sender), _control_handles(handler)
        assert sends, sender.relpath
        assert set(sends) <= set(handles), (sender.relpath, sends, handles)
        unsent = {v for v, line in handles.items() if v not in sends
                  and not CONTROL_RE.search(handler.line(line))}
        assert not unsent, (handler.relpath, unsent)
    # the same verbs as the reference's pair, in both directions
    ref = os.path.join(ROOT, "src", "repro", "runtime")
    jsup = load_module(os.path.join(ref, "supervisor.py"), ROOT)
    jwrk = load_module(os.path.join(ref, "worker.py"), ROOT)
    assert set(_control_sends(sup)) == set(_control_sends(jsup))
    assert set(_control_sends(wrk)) == set(_control_sends(jwrk))
    assert set(_control_handles(wrk)) == set(_control_handles(jwrk))


# -- the handle stands in for a ComputeNode -------------------------------------

# what the port's dispatcher, routers, engine report and controller read
# off a replica (grep of node./r./m. in runtime/{dispatcher,router,engine,
# controller}.py), plus what the router probes with getattr
_NODE_SURFACE = (
    "index", "replica", "inbox", "next_inbox", "retiring", "staged",
    "max_batch", "max_batch_cap", "coalesce_s", "device", "traces",
    "queue_depths", "busy_decode_s", "busy_compute_s", "busy_encode_s",
    "config_records", "_stats_lock", "_threads", "_nodes", "epoch",
    "configure", "precompile", "start", "retire", "join", "reset_stats",
    "snapshot")


def test_worker_handle_covers_the_compute_node_surface():
    """Every attribute the port's runtime reads off a ComputeNode is on a
    live WorkerHandle too, with the node's value types; ``device`` is the
    engine's, and the snapshot has the node's keys."""
    g = mlp_graph()
    eng, sup = supervised_engine(g, g.init(0), TopologySpec.chain(g, 2),
                                 _cfg(), codecs=RAW, max_batch=4,
                                 device="cpu")
    node = ComputeNode(0, WireCodec("raw", "none"), device="cpu")
    try:
        eng.start()             # so shutdown drains the workers cleanly
        h = eng.dispatcher.stages[0].replicas[0]
        assert isinstance(h, WorkerHandle)
        for name in _NODE_SURFACE:
            assert hasattr(node, name), name
            assert hasattr(h, name), name
        assert h.device == eng.device == torch.device("cpu")
        assert h.lost_on_death and callable(h.forwarded_tokens)
        assert set(h.snapshot()) == set(node.snapshot())
        assert [n.name for n in h._nodes] == [
            n.name for n in g.slice_nodes(*eng.dispatcher.partition
                                          .ranges()[0])]
    finally:
        eng.shutdown()
        sup.close()


# -- cross-process channels: expect/dial + the accept guard -------------------

def test_expect_dial_channel_roundtrip():
    tr = TcpTransport()
    inbox, cid = tr.expect_channel(4, role="send")
    host, port = tr.address
    peer = dial_channel(host, port, cid, role="recv", capacity=4)
    env = BatchEnvelope([RowExtent(1, 0, 0, 1)], b"xyz")
    inbox.send(env)
    got = peer.recv()
    assert got.blob == b"xyz" and got.extents == env.extents
    inbox.kill()
    peer.kill()
    tr.close()


def test_unexpect_channel_refuses_late_dial():
    tr = TcpTransport()
    ch, cid = tr.expect_channel(2, role="send")
    host, port = tr.address
    tr.unexpect_channel(cid)
    late = dial_channel(host, port, cid, role="recv", capacity=2)
    with pytest.raises(ChannelClosed):
        late.recv()
    ch.kill()
    late.kill()
    tr.close()


def test_accept_loop_survives_half_open_hello():
    """A client that connects and stalls mid-hello (2 of the 4 cid bytes)
    must not pin the accept thread: it is timed out and dropped, and the
    next well-behaved dial completes."""
    tr = TcpTransport()
    tr.handshake_timeout_s = 0.3        # instance override, test-fast
    ch, cid = tr.expect_channel(2, role="send")
    host, port = tr.address
    stalled = socket.create_connection((host, port))
    try:
        stalled.sendall(struct.pack("<I", cid)[:2])     # ...and stall
        t0 = time.monotonic()
        peer = dial_channel(host, port, cid, role="recv", capacity=2)
        ch.send(BatchEnvelope([RowExtent(1, 0, 0, 1)], b"ok"))
        assert peer.recv().blob == b"ok"
        # served the good client shortly after the guard fired, not never
        assert time.monotonic() - t0 < 10.0
    finally:
        stalled.close()
        ch.kill()
        peer.kill()
        tr.close()


# -- worker graph-factory resolution ------------------------------------------

def test_load_graph_factory_module_and_file_forms():
    by_file = load_graph_factory(GRAPHS + ":mlp_graph")
    assert len(by_file().nodes) == 6
    by_mod = load_graph_factory("tests._torch_worker_graphs:mlp_graph")
    assert len(by_mod().nodes) == len(by_file().nodes)
    by_pkg = load_graph_factory("repro_torch.models.cnn:resnet50")
    assert by_pkg(batch=1, image=64, num_classes=10).name == "resnet50"


def test_load_graph_factory_rejects_bad_specs():
    with pytest.raises(ValueError):
        load_graph_factory("no_colon_here")
    with pytest.raises(ValueError):
        load_graph_factory(":fn_only")
    with pytest.raises(ImportError):
        load_graph_factory("/nonexistent/path/graphs.py:fn")


# -- spawn failure cleanup ----------------------------------------------------

def test_spawn_timeout_cleans_up_no_orphans():
    """A worker binary that exits without ever dialing back must fail the
    spawn loudly and leave nothing behind (the conftest leak fixtures
    assert the 'nothing behind' half)."""
    g = mlp_graph()
    cfg = _cfg(python="/bin/false", spawn_timeout_s=1.0)
    with pytest.raises(ChannelClosed):
        supervised_engine(g, g.init(0), TopologySpec.chain(g, 2), cfg,
                          codecs=RAW, device="cpu")


def test_worker_told_cuda_without_cuda_exits_nonzero(monkeypatch):
    """The engine's device travels in the config frame.  A worker told
    ``cuda:0`` on a machine without CUDA raises before it dials anything:
    the process exits nonzero, the supervisor records the death, the
    start fails loudly, no respawn follows, and no process is left (the
    conftest leak fixture).  The parent is made to believe in CUDA only
    so that its dispatcher accepts the device; nothing runs there."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    g = mlp_graph()
    sup = Supervisor(_cfg())
    try:
        eng = InferenceEngine(g, TopologySpec.chain(g, 2), RAW, max_batch=4,
                              replica_factory=sup.replica_factory,
                              device=torch.device("cuda", 0))
    except BaseException:
        sup.close()
        raise
    chaos = Chaos(sup)
    try:
        eng.configure(g.init(0))
        for stage in (0, 1):
            chaos.wait_death(stage, timeout=60)
        for h in sup._handles:
            assert h.proc.wait(timeout=30) != 0
            assert h.worker_device is None          # never ready
        deaths = chaos.events("death")
        assert all("exited rc=" in e["why"] for e in deaths), deaths
        # the dead worker's control socket (broken pipe) or its exit code
        with pytest.raises(ChannelClosed):
            eng.start()
    finally:
        eng.shutdown()
        sup.close()
    assert not chaos.events("respawn")


# -- end-to-end over real processes -------------------------------------------

def test_procs_end_to_end_numerics_and_clean_drain():
    """Two worker processes serve a 2-stage chain: reference numerics,
    live telemetry flowing back over heartbeats, then a clean drain
    (workers say bye; nothing is killed)."""
    g = mlp_graph()
    params = g.init(0)
    ref = _ref(g, params)
    eng, sup = supervised_engine(g, params, TopologySpec.chain(g, 2),
                                 _cfg(), codecs=RAW, max_batch=4,
                                 device="cpu")
    try:
        eng.start()
        xs = _xs(12)
        outs = [eng.submit(x) for x in xs]
        for x, f in zip(xs, outs):
            np.testing.assert_allclose(f.result(timeout=60), ref(x),
                                       atol=1e-5)
        # telemetry: heartbeat-synthesized snapshots reach the report
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            snaps = [h.snapshot() for h in sup._handles]
            if sum(s["n"] for s in snaps) >= 2 * len(xs):
                break
            time.sleep(0.05)
        assert sum(h.snapshot()["n"] for h in sup._handles) == 2 * len(xs)
        rep = eng.report()
        assert rep.samples >= len(xs)
    finally:
        eng.shutdown()
        sup.close()
    assert not [e for e in sup.events if e["kind"] == "death"]
    assert all(h.bye and h.proc.returncode == 0 for h in sup._handles)


def test_procs_kill_heals_and_respawns_fast():
    """The CI smoke: 2 process replicas on stage 0, SIGKILL one, the
    stage heals (chain keeps answering) and the supervisor respawns it
    within the backoff window — seconds, not minutes."""
    g = mlp_graph()
    params = g.init(0)
    topo = TopologySpec.chain(g, 2).with_replicas(0, 2)
    eng, sup = supervised_engine(g, params, topo, _cfg(), codecs=RAW,
                                 max_batch=4, device="cpu")
    chaos = Chaos(sup)
    try:
        eng.start()
        x = _xs(1)[0]
        want = _ref(g, params)(x)
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), want,
                                   atol=1e-5)
        chaos.kill(chaos.pick(stage=0))
        chaos.wait_death(stage=0, timeout=30)
        # the chain answers while degraded...
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), want,
                                   atol=1e-5)
        # ...and the stage is re-grown through scale() shortly after
        chaos.wait_respawn(stage=0, timeout=30)
        assert chaos.wait_stage_full(eng.dispatcher, 0, timeout=30) == 2
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), want,
                                   atol=1e-5)
    finally:
        eng.shutdown()
        sup.close()


def test_procs_chain_bit_identical_to_inprocess_engine_and_near_jax():
    """The same weights (numpy, from a seed) through the port's in-process
    engine and through its process-backed chain (a replicated stage, raw
    wire, CPU): equal bit for bit; and within 1e-5 of the JAX package's
    ``LayerGraph.apply``.  ``max_batch=1`` so every request computes at
    batch 1 in both engines."""
    g, jg = mlp_graph(), jgraphs.mlp_graph()
    rng = np.random.default_rng(0)
    params = {n.name: {"w": (rng.standard_normal((16, 16)) / 4)
                       .astype(np.float32)} for n in g.nodes}
    topo = TopologySpec.chain(g, 3).with_replicas(1, 2)
    xs = _xs(10)
    inproc = InferenceEngine(g, topo, RAW, max_batch=1, device="cpu")
    try:
        inproc.configure(params)
        want, _ = inproc.run(xs)
    finally:
        inproc.shutdown()
    eng, sup = supervised_engine(g, params, topo, _cfg(), codecs=RAW,
                                 max_batch=1, device="cpu")
    try:
        eng.start()
        futs = [eng.submit(x, client_id=i % 3) for i, x in enumerate(xs)]
        got = [f.result(timeout=60) for f in futs]
    finally:
        eng.shutdown()
        sup.close()
    for a, b, x in zip(got, want, xs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(jg.apply(params, x)),
                                   rtol=0, atol=1e-5)


def test_worker_reports_device_and_block_quant_counters():
    """``ready`` and every ``hb`` carry the worker's device and its
    block-quant counters: on the CPU under q8 each worker runs the plain
    version (``plain_calls`` > 0) and never the kernel."""
    g = mlp_graph()
    params = g.init(0)
    q8 = DispatcherCodecs(data=WireCodec("q8", "none"),
                          weights=WireCodec("raw", "none"))
    eng, sup = supervised_engine(g, params, TopologySpec.chain(g, 2),
                                 _cfg(), codecs=q8, max_batch=4,
                                 device="cpu")
    try:
        eng.start()
        for h in sup._handles:
            assert h.worker_device == "cpu"
            assert h.ready_at - h.spawned_at > 0
        outs, _ = eng.run(_xs(6))
        assert all(np.isfinite(o).all() for o in outs)
        # every worker decodes its input and encodes its output: both
        # plain versions ran there, the kernel never
        def ran(h):
            return all(h.plain_calls.get(k, 0) > 0
                       for k in ("quantize_blocks", "dequantize_blocks"))
        deadline = time.monotonic() + 10
        while (not all(ran(h) for h in sup._handles)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert all(ran(h) and not any(h.launches.values())
                   for h in sup._handles), [
            (h.plain_calls, h.launches) for h in sup._handles]
    finally:
        eng.shutdown()
        sup.close()


def test_first_requests_after_an_idle_spell_are_not_a_stall():
    """Stall detection pages on a backlog that makes no progress for
    ``stall_timeout_s``, counted from when the backlog appeared: a worker
    idle longer than that (every fresh spawn is: its handle is seconds
    old before it serves) and then handed requests that take a moment is
    not stalled.  Counted from the last progress alone, the first sweep
    that sees the backlog kills it (and every respawned replica after
    it), and its requests fail."""
    g = mlp_graph()
    params = g.init(0)
    ref = _ref(g, params)
    topo = TopologySpec.chain(g, 2).with_replicas(0, 2)
    eng, sup = supervised_engine(
        g, params, topo, _cfg(stall_timeout_s=2.0, allow_chaos=True),
        codecs=RAW, max_batch=4, device="cpu")
    chaos = Chaos(sup)
    try:
        eng.precompile()            # first-call costs off the clock
        eng.start()
        chaos.slow_stage(0, 0.3)    # each wave holds its backlog 0.3 s
        time.sleep(2.5)             # an idle spell past the stall timeout
        xs = _xs(6)
        futs = [eng.submit(x, client_id=i) for i, x in enumerate(xs)]
        for x, f in zip(xs, futs):
            np.testing.assert_allclose(f.result(timeout=60), ref(x),
                                       atol=1e-5)
    finally:
        eng.shutdown()
        sup.close()
    assert not chaos.events("death"), chaos.events("death")


def test_a_drained_worker_slow_to_exit_is_not_a_death(monkeypatch):
    """A worker that drained (its egress forwarded _STOP, it said bye) may
    take a while to leave the process table after its sockets close — on
    a card, releasing its CUDA context does.  The monitor must read that
    as the clean exit it is, not as a severed link: no death, no kill.
    The slow exit is mimicked by ``poll()`` reporting the drained
    processes alive while the monitor sweeps."""
    g = mlp_graph()
    params = g.init(0)
    eng, sup = supervised_engine(g, params, TopologySpec.chain(g, 2),
                                 _cfg(), codecs=RAW, max_batch=4,
                                 device="cpu")
    try:
        eng.start()
        outs, _ = eng.run(_xs(4))
        eng.shutdown()
        for h in sup._handles:
            assert h.proc.wait(timeout=30) == 0
            monkeypatch.setattr(h.proc, "poll", lambda: None)
        deadline = time.monotonic() + 10
        while not all(h.inbox.dead or h._outbox.dead for h in sup._handles):
            assert time.monotonic() < deadline, "links never closed"
            time.sleep(0.05)
        for _ in range(3):
            sup._sweep()
    finally:
        eng.shutdown()
        sup.close()
    assert not [e for e in sup.events if e["kind"] == "death"], sup.events


def test_shutdown_returns_with_a_wedged_stage():
    """Both stage-0 workers wedged (hung compute, healthy heartbeats, no
    stall detection), their requests expired by deadline: ``shutdown()``
    severs and reaps them, and must also hand the next stage the _STOP
    they never forwarded, or that stage's router waits for it forever
    (the reference's shutdown hang under load, in its deadline drill)."""
    g = mlp_graph()
    params = g.init(0)
    topo = TopologySpec.chain(g, 2).with_replicas(0, 2)
    eng, sup = supervised_engine(
        g, params, topo,
        _cfg(allow_chaos=True, stall_timeout_s=None, shutdown_grace_s=1.0),
        codecs=RAW, max_batch=4, device="cpu")
    chaos = Chaos(sup)
    done = threading.Event()
    try:
        eng.start()
        x = _xs(1)[0]
        np.testing.assert_allclose(eng.submit(x).result(timeout=60),
                                   _ref(g, params)(x), atol=1e-5)
        assert chaos.hang_stage(0) == 2
        for c in ("a", "b"):
            with pytest.raises(DeadlineExceeded):
                eng.submit(x, client_id=c, deadline_s=0.5).result(timeout=30)
        stopper = threading.Thread(
            target=lambda: (eng.shutdown(), done.set()), daemon=True)
        stopper.start()
        assert done.wait(60), "shutdown hung behind the wedged stage"
    finally:
        sup.close()
