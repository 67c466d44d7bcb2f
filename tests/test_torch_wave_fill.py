"""A bank's resident sessions step together (``runtime/node.py``'s hold,
``runtime/step_graph.py``'s ``StepStaging.due`` and ``StepTimes``).

A wave of decode steps whose bank has due residents holds, bounded by the
replica's recent step time, and takes their steps in as they arrive; the
hold ends when every due session has joined, the wave is full, a frame
other than a step arrives, or the bound has passed, and a session it timed
out on is not waited for again until it steps.  Driven on one replica's
compute thread with the bound injected (so nothing rests on how fast the
host runs), and through a 3-stage chain whose middle stage has two
replicas: the sessions that stage splits step together again at the next,
a lone session never holds, and served tokens equal
``pipeline_decode_reference``'s bit for bit with holds engaged.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.graph import tree_flatten_with_path
from repro_torch.models import lm_graph as tlm
from repro_torch.runtime import (DispatcherCodecs, InferenceEngine,
                                 TopologySpec, WireCodec)
from repro_torch.runtime.node import _STOP, ComputeNode, _Decoded
from repro_torch.runtime.session import live_session_stores
from repro_torch.runtime.step_graph import STEP_TIMES, StepTimes
from repro_torch.runtime.wire import K_CLOSE, K_OPEN, K_STEP, RowExtent

torch.set_num_threads(1)

LM = dict(vocab=48, d_model=32, n_layers=2, num_heads=4, kv_heads=2,
          head_dim=8, d_ff=64, cache_len=48)
CODECS = DispatcherCodecs(data=WireCodec("raw", "none"),
                          weights=WireCodec("raw", "none"))
PROMPTS = [[1, 5, 9, 2], [3, 3, 7], [2, 8, 4, 6, 1], [11, 0, 5, 5],
           [7, 7], [4, 1, 0, 9, 9, 3], [10, 2, 2], [6, 5, 4, 3],
           [9, 8], [0, 1, 2, 3, 4], [5], [8, 8, 1]]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_port_session_residue():
    """Resident decode-session caches must be evicted on session end."""
    yield
    residue = {id(s): s.keys() for s in live_session_stores() if len(s)}
    assert not residue, f"leaked resident decode-session caches: {residue}"


@pytest.fixture(scope="module")
def lm():
    """The graph and numpy params: norm scales 1, the embedding table
    ``~ N(0, 1)``, every other weight ``~ N(0, 1/fan_in)``."""
    graph = tlm.decode_lm_graph(use_kernel=True, **LM)
    rng = np.random.default_rng(0)
    params = {}
    for node in graph.nodes:
        p: dict = {}
        for path, spec in tree_flatten_with_path(node.param_spec):
            shape = tuple(spec.shape)
            a = (np.ones(shape, np.float32) if path[-1] == "scale"
                 else rng.standard_normal(shape, np.float32))
            if path[-1] not in ("scale", "table"):
                a *= np.float32(1 / np.sqrt(shape[-2]))
            d = p
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = a
        params[node.name] = p
    return graph, params


class Fixed:
    """A replica's step times with the bound the test sets."""

    def __init__(self, bound: float):
        self.s = bound

    def add(self, s: float) -> None:
        pass

    def bound(self) -> float:
        return self.s


# -- the bank's rows and the replica's step times ------------------------------

def test_step_times_bound_is_the_median_of_the_last_steps():
    t = StepTimes()
    assert t.bound() is None
    for s in (9.0, 1.0, 3.0):
        t.add(s)
    assert t.bound() == 3.0
    for _ in range(STEP_TIMES):         # 9, 1 and 3 fall out
        t.add(2.0)
    assert t.bound() == 2.0


class Replica:
    """A replica serving the whole graph; its compute thread runs while the
    test feeds its queue and reads what it computed."""

    def __init__(self, lm):
        graph, params = lm
        self.node = node = ComputeNode(0, CODECS.data, device=CPU)
        node._graph = graph
        node._set_range(0, len(graph.nodes))
        node._params = graph.prepare(params, CPU)
        node._make_apply()
        self.rng = np.random.default_rng(3)
        self.pos: dict[str, int] = {}
        self.thread: threading.Thread | None = None
        # set as the compute thread starts each hold
        self.held = threading.Event()
        hold = node._hold

        def spy(group):
            h = hold(group)
            if h is not None:
                self.held.set()
            return h
        node._hold = spy

    def frame(self, kind: int, sid: str) -> _Decoded:
        if kind == K_OPEN:
            n = int(self.rng.integers(3, 12))
            x = self.rng.integers(0, LM["vocab"], (1, n), dtype=np.int32)
            self.pos[sid] = n
        else:
            x = self.rng.integers(0, LM["vocab"], (1, 1), dtype=np.int32)
        pos = self.pos.get(sid, 0)
        if kind == K_STEP:
            self.pos[sid] += 1
        return _Decoded([RowExtent(0, sid, 0, 1, session=sid, pos=pos,
                                   kind=kind)], {"": x}, 0.0,
                        time.perf_counter())

    def group(self, kind: int, sids: list[str]) -> None:
        """One merged group, served on the test's thread (no hold)."""
        _, fails, _, _ = self.node._decode_group(
            [self.frame(kind, s) for s in sids])
        assert not fails, fails[0].error

    def start(self, bound: float) -> None:
        self.node.step_times = Fixed(bound)
        self.thread = threading.Thread(target=self.node._compute_loop,
                                       daemon=True)
        self.thread.start()

    def put(self, kind: int, *sids: str) -> None:
        """One decoded wave of ``sids``' frames onto the compute queue."""
        self.node._to_compute.put([self.frame(kind, s) for s in sids])

    def served(self) -> list[str]:
        """The sessions of the next wave the compute thread hands on."""
        out = self.node._to_encode.get(timeout=60)
        return [ext[0].session for ext, _ in out.buckets]

    def stop(self) -> None:
        if self.thread is not None:
            self.node._to_compute.put(_STOP)
            self.thread.join(60)
            assert not self.thread.is_alive()
        self.node.sessions.clear()

    def counts(self) -> tuple[int, int, float]:
        w = self.node.window
        return (w.step_counts["step_holds"], w.step_counts["step_hold_joins"],
                w.step_s["hold"])


def test_due_rows_are_the_bank_residents_not_behind_the_wave(lm):
    """A resident is due for a wave when its last step here came no later
    than the slack after the wave's latest; rows not held, rows in the
    wave and late rows never are; an open counts as a last step, and a
    step clears a late mark."""
    r = Replica(lm)
    try:
        r.group(K_OPEN, ["a", "b", "c", "d", "e"])
        r.group(K_CLOSE, ["e"])
        bank = r.node._banks[0]
        rows = {s: r.node.sessions.get(s).row for s in "abcd"}
        assert [rows[s] for s in "abcd"] == [0, 1, 2, 3]
        assert all(t > 0 for t in bank.last[:5])         # the opens
        bank.last[:4] = [10.0, 10.0, 10.5, 30.0]
        assert bank.due([0], 0.0) == [1]
        assert bank.due([0], 1.0) == [1, 2]
        assert bank.due([0, 2], 0.0) == [1]
        assert bank.due([3], 0.0) == [0, 1, 2]
        bank.late[1] = True
        assert bank.due([0], 1.0) == [2]
        t = time.perf_counter()
        r.group(K_STEP, ["b"])
        assert bank.last[1] >= t and not bank.late[1]
    finally:
        r.stop()


def test_before_its_first_step_a_replica_does_not_hold(lm):
    """No step time yet, no bound: a wave of one of two residents steps
    at once, and its step gives the replica a bound; with one, the next
    such wave holds for the other, which joins."""
    r = Replica(lm)
    try:
        r.group(K_OPEN, ["a", "b"])
        r.thread = threading.Thread(target=r.node._compute_loop, daemon=True)
        r.thread.start()
        r.put(K_STEP, "a")
        assert r.served() == ["a"]
        assert r.counts()[0] == 0
        assert r.node.step_times.bound() > 0
        r.node.step_times = Fixed(30.0)
        r.put(K_STEP, "a")              # b, behind a, is due
        assert r.held.wait(60)
        r.put(K_STEP, "b")
        assert sorted(r.served()) == ["a", "b"]
        assert r.counts()[:2] == (1, 1)
    finally:
        r.stop()


def test_due_residents_join_and_the_counters_count(lm):
    """Three residents that stepped together: a wave of ``a`` holds for
    ``b`` and ``c``; ``b``'s step arrives during the hold and joins, ``c``
    never does, so the hold ends at the bound and the wave steps ``a`` and
    ``b`` in one apply.  ``step_holds`` counts the wave, ``step_hold_joins``
    the step that joined, ``step_hold_s`` the seconds held, which the
    ``step.hold`` span covers; ``c`` is then late, so the next wave of
    ``a`` and ``b`` steps at once, until ``c`` steps again."""
    bound = 0.2
    r = Replica(lm)
    node = r.node
    try:
        r.group(K_OPEN, ["a", "b", "c"])
        r.group(K_STEP, ["a", "b", "c"])
        node.reset_stats()
        node.spans.start()
        r.start(bound)
        r.put(K_STEP, "a")
        assert r.held.wait(60)
        r.put(K_STEP, "b")
        assert sorted(r.served()) == ["a", "b"]
        holds, joins, held_s = r.counts()
        assert (holds, joins) == (1, 1)
        assert bound <= held_s + 1e-3 < bound + 30
        counts = node.window.step_counts
        assert counts["step_live_rows"] == 2
        assert counts["step_rows_run"] == node._step_rows
        bank = node._banks[0]
        assert bank.late == [False, False, True] + [False] * (bank.rows - 3)
        spans = [s for s in node.spans.stop().spans
                 if s.name == "defer.s0.step.hold"]
        assert len(spans) == 1 and sorted(spans[0].sessions) == ["a", "b"]
        assert (spans[0].end_ns - spans[0].start_ns) / 1e9 \
            == pytest.approx(held_s, abs=1e-6)
        r.put(K_STEP, "a", "b")         # nothing due: c is late
        assert sorted(r.served()) == ["a", "b"]
        assert r.counts()[0] == 1
        r.put(K_STEP, "c")              # a and b stepped over a bound after c
        assert r.served() == ["c"]
        assert r.counts()[0] == 1 and not bank.late[2]
    finally:
        r.stop()


@pytest.mark.parametrize("how", ["silent", "closed"])
def test_a_hold_for_a_session_that_never_steps_ends(lm, how):
    """``b`` is due but never steps again: its client went away
    (``silent``), and the hold ends at the bound; or its close arrives
    during the hold (``closed``), which ends the hold at once and is
    served with the wave."""
    bound = 0.1 if how == "silent" else 30.0
    r = Replica(lm)
    try:
        r.group(K_OPEN, ["a", "b"])
        r.group(K_STEP, ["a", "b"])
        r.start(bound)
        t0 = time.perf_counter()
        r.put(K_STEP, "a")
        assert r.held.wait(60)
        if how == "closed":
            r.put(K_CLOSE, "b")
            assert sorted(r.served()) == ["a", "b"]
            assert r.node.sessions.keys() == ["a"]
        else:
            assert r.served() == ["a"]
        took = time.perf_counter() - t0
        holds, joins, held_s = r.counts()
        assert (holds, joins) == (1, 0)
        if how == "silent":
            assert bound <= held_s + 1e-3 and took < bound + 30
        else:
            assert held_s < bound / 2 and took < bound / 2
    finally:
        r.stop()


# -- through a chain whose middle stage has two replicas ------------------------

def _refs(lm, jobs):
    graph, params = lm
    prep = graph.prepare(params, CPU)
    return [tlm.pipeline_decode_reference(graph, prep, p, m)
            for p, m in jobs]


def _chain(lm, slow_s: float = 0.0) -> InferenceEngine:
    """Stages [1, 2, 1] on the CPU; with ``slow_s`` the middle stage's
    second replica sleeps that long before each step, so the sessions it
    serves reach the next stage after the first replica's."""
    graph, params = lm
    eng = InferenceEngine(graph, TopologySpec.chain(graph, 3)
                          .with_replicas(1, 2), CODECS, device="cpu")
    eng.configure(params)
    if slow_s:
        node = eng.dispatcher.stages[1].replicas[1]
        step = node._step_wave

        def slow(*a, **k):
            time.sleep(slow_s)
            return step(*a, **k)
        node._step_wave = slow
    return eng


def _serve(eng, jobs, threads: int, together: bool = False):
    """``jobs`` (prompt, new tokens) served by ``threads`` client threads,
    each opening its next session when its last one ends; ``together``:
    one job a thread, each stepping only once every session has opened."""
    outs: list = [None] * len(jobs)
    errs: list = []
    lock = threading.Lock()
    todo = list(range(len(jobs)))
    opened = threading.Barrier(threads)

    def client():
        while True:
            with lock:
                if not todo or errs:
                    return
                i = todo.pop(0)
            try:
                gen = eng.generate(*jobs[i])
                toks = [next(gen)]
                if together:
                    opened.wait(60)
                outs[i] = toks + list(gen)
            except BaseException as e:      # noqa: BLE001 - re-raised below
                errs.append(e)
                opened.abort()

    ts = [threading.Thread(target=client) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not any(t.is_alive() for t in ts), "generation hung"
    if errs:
        raise errs[0]
    return outs


def _per_replica(eng) -> dict[tuple[int, int], dict]:
    return {(n["stage"], n["replica"]): n for n in eng.report().per_node}


def test_sessions_split_at_a_replicated_stage_step_together_after_it(
        lm, monkeypatch):
    """Two sessions, one on each replica of the middle stage, whose second
    replica is the slower: at the last stage the first's step holds for
    the second's, which joins, so every step there, as at the first stage,
    serves both sessions in one apply.  A middle replica holds one session
    and never holds.  The tokens equal the reference's bit for bit."""
    monkeypatch.setattr(StepTimes, "bound", lambda self: 5.0)
    jobs = [(PROMPTS[0], 8), (PROMPTS[3], 8)]
    eng = _chain(lm, slow_s=0.05)
    try:
        eng.start()
        got = _serve(eng, jobs, 2, together=True)
        per = _per_replica(eng)
    finally:
        eng.shutdown()
    assert got == _refs(lm, jobs)
    steps = jobs[0][1] - 1
    for stage in (0, 2):
        n = per[stage, 0]
        assert n["step_live_rows"] == 2 * steps
        assert n["step_graph_replays"] + n["step_eager_steps"] == steps
    assert per[2, 0]["step_hold_joins"] > 0
    for replica in (0, 1):
        n = per[1, replica]
        assert n["step_live_rows"] == steps and n["step_holds"] == 0


@pytest.mark.parametrize("bound", ["injected", "own"])
def test_a_lone_session_never_holds(lm, monkeypatch, bound):
    """One session through the chain: no replica holds, whatever its
    bound, and the tokens equal the reference's."""
    if bound == "injected":
        monkeypatch.setattr(StepTimes, "bound", lambda self: 5.0)
    jobs = [(PROMPTS[2], 8)]
    eng = _chain(lm)
    try:
        eng.start()
        got = _serve(eng, jobs, 1)
        per = _per_replica(eng)
    finally:
        eng.shutdown()
    assert got == _refs(lm, jobs)
    assert all(n["step_holds"] == 0 and n["step_hold_s"] == 0
               for n in per.values())
    assert sum(n["step_live_rows"] for n in per.values()) == 3 * 7


@pytest.mark.parametrize("bound", ["injected", "own"])
def test_tokens_equal_the_reference_with_holds_engaged(lm, monkeypatch,
                                                       bound):
    """Twelve sessions of different lengths over eight clients, sessions
    closing and opening between waves: the tokens equal the reference's
    bit for bit, with the bound injected (where the slow middle replica
    makes holds certain) or each replica's own; a hold's joins are steps
    the replica served, and it served each session's steps once."""
    if bound == "injected":
        monkeypatch.setattr(StepTimes, "bound", lambda self: 0.5)
    jobs = [(p, 4 + (3 * i) % 9) for i, p in enumerate(PROMPTS)]
    eng = _chain(lm, slow_s=0.02 if bound == "injected" else 0.0)
    try:
        eng.start()
        got = _serve(eng, jobs, 8)
        per = _per_replica(eng)
    finally:
        eng.shutdown()
    assert got == _refs(lm, jobs)
    for n in per.values():
        assert n["step_hold_joins"] <= n["step_live_rows"]
        assert (n["step_holds"] > 0) == (n["step_hold_s"] > 0)
    served = sum(m - 1 for _, m in jobs)
    for stage in range(3):
        assert sum(n["step_live_rows"] for (s, _), n in per.items()
                   if s == stage) == served
    if bound == "injected":
        assert sum(n["step_holds"] for n in per.values()) > 0
