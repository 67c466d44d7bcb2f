"""Chaos drills on the port: the 12 drills of ``tests/test_chaos.py`` on
``repro_torch``'s supervisor through ``tools/torch_chaos.py`` — kill, hang,
slow and sever worker processes under closed-loop load and prove the
serving contract: a fault fails exactly the batches it stranded
(NodeError, never a hang), the chain keeps answering on the survivors,
the supervisor respawns within its backoff window, an exhausted respawn
budget degrades instead of wedging or storming, replay hides a kill from
every client, and a full kill/respawn/kill cycle resolves every future.

Every wait is on the supervisor's ``events`` or on a future; no drill
asserts a wall-clock bound (the deadline drill proves the reaper by
``DeadlineExceeded`` arriving within ``result(timeout=...)``).  The
reference is the port's own single-device apply on the CPU, where every
worker computes (``device="cpu"``, ``OMP_NUM_THREADS=1``).  All drills
spawn real worker processes (``allow_chaos=True``) and are marked slow,
as their twins are; the fast smoke lives in ``test_torch_supervisor.py``.
"""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.models.lm_graph import pipeline_decode_reference
from repro_torch.runtime import NodeError, TopologySpec
from repro_torch.runtime.dispatcher import (DeadlineExceeded,
                                            DispatcherCodecs, RetryPolicy)
from repro_torch.runtime.supervisor import (SupervisorConfig, WorkerHandle,
                                            supervised_engine)
from repro_torch.runtime.wire import WireCodec
from tests._torch_worker_graphs import (POISON, lm_graph, mlp_graph,
                                        poison_graph)
from tools.torch_chaos import Chaos

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

GRAPHS = os.path.join(os.path.dirname(__file__), "_torch_worker_graphs.py")
RAW = DispatcherCodecs(data=WireCodec("raw", "none"),
                       weights=WireCodec("raw", "none"))
D = 16


def _cfg(**kw):
    kw.setdefault("graph_factory", GRAPHS + ":mlp_graph")
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("heartbeat_timeout_s", 5.0)
    kw.setdefault("backoff_initial_s", 0.1)
    kw.setdefault("backoff_max_s", 0.5)
    kw.setdefault("shutdown_grace_s", 5.0)
    kw.setdefault("allow_chaos", True)
    kw.setdefault("env", {"OMP_NUM_THREADS": "1"})
    return SupervisorConfig(**kw)


def _build(cfg, replicas=2, graph=mlp_graph, **engine_kw):
    g = graph()
    params = g.init(0)
    topo = TopologySpec.chain(g, 2).with_replicas(0, replicas)
    engine_kw.setdefault("codecs", RAW)
    engine_kw.setdefault("max_batch", 4)
    eng, sup = supervised_engine(g, params, topo, cfg, device="cpu",
                                 **engine_kw)
    prep = g.prepare(params, "cpu")
    ref = lambda x: g.apply(prep, torch.from_numpy(x)).numpy()  # noqa: E731
    return g, prep, ref, eng, sup


def _x(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(1, D)).astype(np.float32)


def _wait_ok(load, n: int, timeout: float = 60.0) -> None:
    """Until ``load`` has ``n`` successes: a future-driven ramp, with the
    timeout a guard against a hang, not a bound under test."""
    deadline = time.monotonic() + timeout
    while load.ok < n and time.monotonic() < deadline and \
            not load.violations:
        time.sleep(0.02)
    assert load.ok >= n, f"load never ramped ({load.ok} < {n})"


class _Load:
    """Closed-loop clients: each keeps exactly one request in flight.
    Every future must resolve — with a value or a NodeError; anything
    else (timeout, foreign exception) is a hang/contract violation."""

    def __init__(self, eng, clients=4, timeout=60.0, ref=None):
        self.eng = eng
        self.timeout = timeout
        self.ref = ref          # optional x -> expected output (numerics)
        self.ok = 0
        self.failed = 0
        self.violations: list[str] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(c,),
                                          daemon=True)
                         for c in range(clients)]

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def _run(self, cid):
        i = 0
        while not self._stop.is_set():
            x = _x(i)
            f = self.eng.submit(x, client_id=f"c{cid}")
            try:
                out = f.result(timeout=self.timeout)
                if self.ref is not None and not np.allclose(
                        out, self.ref(x), atol=1e-5):
                    with self._lock:
                        self.violations.append(
                            f"numerically wrong output for client {cid} "
                            f"request {i}")
                    return
                with self._lock:
                    self.ok += 1
            except NodeError:
                with self._lock:
                    self.failed += 1
            except Exception as e:     # noqa: BLE001 - the assertion itself
                with self._lock:
                    self.violations.append(f"{type(e).__name__}: {e}")
                return
            i += 1

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(self.timeout + 30)
        assert not any(t.is_alive() for t in self._threads), \
            "load client hung: some future never resolved"
        assert not self.violations, \
            f"futures must resolve with a value or NodeError: " \
            f"{self.violations}"


def test_kill_mid_batch_fails_only_stranded_chain_keeps_serving():
    """SIGKILL one of two stage-0 worker processes mid-batch under
    closed-loop load: the stranded batches fail with NodeError, nothing
    hangs, the chain keeps answering on the survivor, and the supervisor
    respawns the replica within the backoff window."""
    g, prep, ref, eng, sup = _build(_cfg())
    chaos = Chaos(sup)
    try:
        eng.start()
        # dwell in compute so the kill lands mid-batch, not between them
        for h in chaos.workers(stage=0):
            chaos.slow_compute(h, 0.05)
        with _Load(eng) as load:
            _wait_ok(load, 20)
            chaos.kill(chaos.pick(stage=0))
            death = chaos.wait_death(stage=0, timeout=30)[0]
            assert "exited" in death["why"]
            chaos.wait_respawn(stage=0, timeout=60)
            assert chaos.wait_stage_full(eng.dispatcher, 0,
                                         timeout=60) == 2
        # closed-loop accounting: everything resolved, the kill cost at
        # most the batches inside the dead worker's pipeline
        assert load.failed <= 4 * eng.dispatcher._defaults["queue_depth"]
        # and the healed chain still answers with reference numerics
        x = _x(7)
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-5)
    finally:
        eng.shutdown()
        sup.close()


def test_kill_respawn_kill_cycle_zero_hangs():
    """Two kills with a respawn between them, all under load: every
    future resolves (ok or NodeError), both deaths heal, and shutdown is
    clean — the full cycle the self-healing loop must survive."""
    g, prep, ref, eng, sup = _build(_cfg())
    chaos = Chaos(sup)
    try:
        eng.start()
        with _Load(eng) as load:
            for round_no in (1, 2):
                _wait_ok(load, load.ok + 10)
                chaos.kill(chaos.pick(stage=0))
                chaos.wait_death(stage=0, count=round_no, timeout=30)
                chaos.wait_respawn(stage=0, count=round_no, timeout=60)
                assert chaos.wait_stage_full(eng.dispatcher, 0,
                                             timeout=60) == 2
        assert load.ok > 0
    finally:
        eng.shutdown()
        sup.close()
    kinds = [e["kind"] for e in sup.events]
    assert kinds.count("death") >= 2 and kinds.count("respawn") >= 2
    assert "degraded" not in kinds


def test_respawn_budget_exhaustion_degrades_not_wedges():
    """With a budget of 1, the second kill exhausts it: the supervisor
    records a degrade, stops respawning (no storm), and the stage keeps
    serving on its survivor — no wedge, no hang."""
    g, prep, ref, eng, sup = _build(_cfg(respawn_budget=1, stable_s=3600.0))
    chaos = Chaos(sup)
    try:
        eng.start()
        x = _x()
        chaos.kill(chaos.pick(stage=0))
        chaos.wait_respawn(stage=0, timeout=60)
        chaos.wait_stage_full(eng.dispatcher, 0, timeout=60)
        chaos.kill(chaos.pick(stage=0))
        chaos.wait_event("degraded", stage=0, timeout=30)
        # degraded, not dead: the survivor answers
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-5)
        live = [r for r in eng.dispatcher.stages[0].live_replicas()
                if not r.retiring]
        assert len(live) == 1
        # no respawn storm after the degrade: every respawner has
        # returned, and one respawn is all there was
        with sup._lock:
            respawners = list(sup._respawners)
        for t in respawners:
            t.join(30)
            assert not t.is_alive(), "a respawner is still running"
        assert len(chaos.events("respawn", stage=0)) == 1
    finally:
        eng.shutdown()
        sup.close()


def test_sigkill_during_spawn_fence(monkeypatch):
    """The nastiest window: the replacement worker is killed right after
    start(), while the membership fence that admits it is in flight.
    The heal path must proxy the dead newcomer's fence share (scale()
    un-wedges), and the NEXT respawn attempt restores the stage."""
    g, prep, ref, eng, sup = _build(_cfg(spawn_timeout_s=60.0))
    chaos = Chaos(sup)
    kill_next = threading.Event()
    orig_start = WorkerHandle.start

    def start_then_die(self):
        orig_start(self)
        if kill_next.is_set():
            kill_next.clear()
            os.kill(self.proc.pid, signal.SIGKILL)

    monkeypatch.setattr(WorkerHandle, "start", start_then_die)
    try:
        eng.start()
        kill_next.set()     # arms for the NEXT spawn: the respawned worker
        chaos.kill(chaos.pick(stage=0))
        # two deaths: the original kill, then the fence-window kill
        chaos.wait_death(stage=0, count=2, timeout=60)
        assert chaos.wait_stage_full(eng.dispatcher, 0, timeout=60) == 2
        x = _x()
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-5)
    finally:
        eng.shutdown()
        sup.close()


def test_slow_but_alive_worker_is_not_falsely_killed():
    """A worker whose compute is dilated way past the heartbeat timeout
    is SLOW, not DEAD: its heartbeat thread stays healthy, so failure
    detection must not page — zero deaths, all futures resolve."""
    g, prep, ref, eng, sup = _build(
        _cfg(heartbeat_timeout_s=0.5, stall_timeout_s=None))
    chaos = Chaos(sup)
    try:
        eng.start()
        for h in chaos.workers(stage=0):
            chaos.slow_compute(h, 0.8)      # >> heartbeat_timeout_s
        xs = [_x(i) for i in range(6)]
        outs = [eng.submit(x) for x in xs]
        for x, f in zip(xs, outs):
            np.testing.assert_allclose(f.result(timeout=60), ref(x),
                                       atol=1e-5)
        assert not chaos.events("death"), \
            "slow-but-alive worker was falsely declared dead"
    finally:
        eng.shutdown()
        sup.close()


def test_hung_compute_caught_by_stall_detection():
    """The inverse failure mode: a wedged compute thread with a healthy
    heartbeat.  Heartbeat-age detection can never fire; stall detection
    (snapshot frozen + inbox backlog) must kill and heal it, failing the
    wedged batches with NodeError and respawning the replica."""
    g, prep, ref, eng, sup = _build(_cfg(stall_timeout_s=1.0))
    chaos = Chaos(sup)
    try:
        eng.start()
        victim = chaos.pick(stage=0)
        chaos.hang_compute(victim)
        with _Load(eng, clients=4):
            death = chaos.wait_death(stage=0, timeout=60)[0]
            assert "stalled" in death["why"]
            chaos.wait_respawn(stage=0, timeout=60)
            assert chaos.wait_stage_full(eng.dispatcher, 0,
                                         timeout=60) == 2
    finally:
        eng.shutdown()
        sup.close()


def test_kill_with_replay_zero_client_visible_failures():
    """THE replay contract: SIGKILL one of two stage-0 workers mid-batch
    under closed-loop load WITH a retry policy — every submitted future
    resolves with a numerically correct output.  Zero NodeErrors reach a
    client (the stranded batches are re-admitted through the healed
    routing set), zero hangs, and the replay counters show it actually
    happened rather than the kill landing between batches."""
    g, prep, ref, eng, sup = _build(
        _cfg(), retry_policy=RetryPolicy(max_attempts=5, backoff_s=0.05,
                                         retry_budget=64.0,
                                         refill_per_s=32.0))
    chaos = Chaos(sup)
    try:
        eng.start()
        chaos.slow_stage(0, 0.05)   # dwell in compute: kill lands mid-batch
        with _Load(eng, ref=ref) as load:
            _wait_ok(load, 20)
            chaos.kill(chaos.pick(stage=0))
            chaos.wait_death(stage=0, timeout=30)
            chaos.wait_respawn(stage=0, timeout=60)
            assert chaos.wait_stage_full(eng.dispatcher, 0,
                                         timeout=60) == 2
            # keep serving across the heal so replayed work interleaves
            # with fresh admissions
            _wait_ok(load, load.ok + 10)
        assert load.failed == 0, \
            f"{load.failed} client-visible failures despite replay"
        st = eng.dispatcher.replay_stats
        assert st.replays >= 1, "kill landed between batches: no replay " \
            f"exercised ({st})"
    finally:
        eng.shutdown()
        sup.close()


def test_application_error_is_not_retried():
    """A poison input makes user apply() raise — an APPLICATION error.
    With a generous retry policy the future must still fail with
    NodeError after exactly one attempt (zero replays): retrying
    deterministic user errors would burn budget and double-charge
    side-effecting layers."""
    g, prep, ref, eng, sup = _build(
        _cfg(graph_factory=GRAPHS + ":poison_graph"), graph=poison_graph,
        retry_policy=RetryPolicy(max_attempts=5, retry_budget=64.0))
    try:
        eng.start()
        x = _x()
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-5)
        bad = x.copy()
        bad[0, 0] = POISON
        with pytest.raises(NodeError, match="poison pill"):
            eng.submit(bad).result(timeout=60)
        st = eng.dispatcher.replay_stats
        assert st.replays == 0, \
            f"application error was replayed ({st})"
        # the chain is unharmed: clean requests still serve
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-5)
    finally:
        eng.shutdown()
        sup.close()


def test_retry_budget_exhaustion_degrades_to_fail_fast():
    """A zero-token bucket (budget 0, no refill) means every would-be
    replay is refused: the kill behaves exactly like fail-fast —
    stranded futures fail with NodeError, nothing hangs, and the denial
    is visible in the counters.  This is the crash-storm valve: when
    replays can't be afforded, the layer degrades instead of amplifying
    load."""
    g, prep, ref, eng, sup = _build(
        _cfg(), retry_policy=RetryPolicy(max_attempts=5, retry_budget=0.0,
                                         refill_per_s=0.0))
    chaos = Chaos(sup)
    try:
        eng.start()
        chaos.slow_stage(0, 0.05)
        with _Load(eng) as load:
            _wait_ok(load, 10)
            chaos.kill(chaos.pick(stage=0))
            chaos.wait_death(stage=0, timeout=30)
            chaos.wait_respawn(stage=0, timeout=60)
            assert chaos.wait_stage_full(eng.dispatcher, 0,
                                         timeout=60) == 2
        # _Load.stop() (in __exit__) already asserted zero hangs; the
        # kill's stranded batches surfaced as NodeError because the
        # bucket refused their replay
        st = eng.dispatcher.replay_stats
        assert st.budget_denied >= 1, f"no replay was ever denied ({st})"
        assert st.replays == 0, f"replay happened on a dry bucket ({st})"
        assert load.failed >= 1, "kill landed between batches: " \
            "fail-fast degradation not exercised"
    finally:
        eng.shutdown()
        sup.close()


def test_deadline_expires_on_hung_worker_in_bounded_time():
    """Wedge EVERY stage-0 worker (healthy heartbeats, nothing to route
    around) and submit with a deadline: the future must fail with
    DeadlineExceeded within ``result(timeout=...)`` — the reaper's
    monotonic clock, not stall detection, is what unblocks the client.
    Stall detection is configured far slower than the deadline and has
    recorded no death when the deadlines have fired, so the heal
    demonstrably lost the race; it then recovers the stage for a clean
    shutdown."""
    g, prep, ref, eng, sup = _build(_cfg(stall_timeout_s=4.0))
    chaos = Chaos(sup)
    try:
        eng.start()
        x = _x()
        # warm the chain so the hang catches a steady state
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-5)
        assert chaos.hang_stage(0) == 2
        # two requests: lqd spreads them across both wedged workers
        futs = [eng.submit(x, client_id=c, deadline_s=0.5)
                for c in ("da", "db")]
        for fut in futs:
            with pytest.raises(DeadlineExceeded):
                fut.result(timeout=30)
        assert eng.dispatcher.replay_stats.deadlines_expired >= 2
        assert not chaos.events("death"), "stall detection won the race"
        # let stall detection heal the wedged stage before teardown —
        # closed-loop load builds the inbox backlog stall detection keys
        # on (their stranded futures legally fail with NodeError)
        # (both wedged workers stall together, so one respawn may grow the
        # stage back by two)
        with _Load(eng):
            chaos.wait_death(stage=0, count=2, timeout=60)
            chaos.wait_respawn(stage=0, timeout=60)
            assert chaos.wait_stage_full(eng.dispatcher, 0,
                                         timeout=60) == 2
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-5)
    finally:
        eng.shutdown()
        sup.close()


def test_kill_mid_generation_sessions_reprefill_chain_keeps_serving():
    """SIGKILL one of two stage-0 worker processes while decode sessions
    are mid-generation: the victims' resident KV caches die with it, the
    displaced sessions re-prefill their retained history onto the
    survivor (restart='auto' + RetryPolicy) and finish BIT-IDENTICAL to
    the single-device reference, sessions pinned to the survivor never
    notice, the supervisor respawns the replica, and single-shot traffic
    still answers afterwards — no hangs anywhere."""
    g, prep, ref, eng, sup = _build(
        _cfg(graph_factory=GRAPHS + ":lm_graph"), graph=lm_graph,
        retry_policy=RetryPolicy(max_attempts=5, backoff_s=0.05,
                                 retry_budget=64.0, refill_per_s=32.0))
    chaos = Chaos(sup)
    prompts = [[1, 5, 9, 2], [3, 3, 7], [2, 8, 4, 6, 1]]
    m = 30
    outs = [[] for _ in prompts]
    errs: list[BaseException] = []

    def one(i, p):
        try:
            for tok in eng.generate(p, m):
                outs[i].append(tok)
        except BaseException as e:      # noqa: BLE001 - asserted below
            errs.append(e)

    try:
        eng.start()
        threads = [threading.Thread(target=one, args=(i, p))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while not all(len(o) >= 3 for o in outs):
            assert time.monotonic() < deadline, \
                f"sessions never ramped: {[len(o) for o in outs]}"
            assert not errs, f"session died before the kill: {errs}"
            time.sleep(0.01)
        chaos.kill(chaos.pick(stage=0))
        chaos.wait_death(stage=0, timeout=30)
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads), "generation hung"
        assert not errs, f"sessions dropped across the kill: {errs}"
        assert outs == [pipeline_decode_reference(g, prep, p, m)
                        for p in prompts]
        # the stage heals, and plain single-shot traffic still answers
        chaos.wait_respawn(stage=0, timeout=60)
        assert chaos.wait_stage_full(eng.dispatcher, 0, timeout=60) == 2
        x = np.asarray([prompts[0]], np.int32)
        np.testing.assert_allclose(eng.submit(x).result(timeout=60), ref(x),
                                   atol=1e-4)
    finally:
        eng.shutdown()
        sup.close()


def test_severed_sockets_heal_like_a_crash():
    """Cut a worker's data sockets mid-batch (flaky link, process still
    alive): the routers heal exactly as for a crash, the monitor retires
    the unreachable orphan and respawns it, and the chain keeps serving
    throughout — no hang."""
    g, prep, ref, eng, sup = _build(_cfg())
    chaos = Chaos(sup)
    try:
        eng.start()
        for h in chaos.workers(stage=0):
            chaos.slow_compute(h, 0.05)
        with _Load(eng) as load:
            _wait_ok(load, 10)
            chaos.sever(chaos.pick(stage=0))
            death = chaos.wait_death(stage=0, timeout=30)[0]
            assert "severed" in death["why"]
            chaos.wait_respawn(stage=0, timeout=60)
            assert chaos.wait_stage_full(eng.dispatcher, 0,
                                         timeout=60) == 2
            # the chain kept serving across the whole failover
            _wait_ok(load, load.ok + 10)
    finally:
        eng.shutdown()
        sup.close()
