"""The program's spans and thread clocks on the benchmark's side: the four
readers on a synthetic run and on a tiny real one, the spans' mapping onto
the trace's clock and its 1-ms check, and idle gaps named by work spans
only."""
from __future__ import annotations

import io
import json
import threading
import time

import pytest

from conftest import tiny

READERS = ["step_launch_ms.decode", "cache_copy_ms.decode",
           "queue_wait_ms.decode", "program_cpu_ms.decode"]


def _run(report):
    from bench.harness.load import Run, Session
    run = Run("c", {}, {}, 1.0, report=report)
    for i, n in enumerate((3, 5)):            # 8 tokens served
        s = Session(i, i, [1, 2], n)
        s.tokens = list(range(n))
        run.sessions.append(s)
    return run


SYNTHETIC = {
    "per_node": [
        {"step_stack_s": 0.010, "step_launch_s": 0.040, "step_sync_s": 0.5,
         "step_unstack_s": 0.006},
        {"step_stack_s": 0.002, "step_launch_s": 0.024, "step_sync_s": 0.1,
         "step_unstack_s": 0.006}],
    "step_wait_s": {"admission": 0.008, "s0.inbox": 0.016, "result": 0.04},
    "thread_cpu_s": {"defer-pump": 0.2, "defer-s0r0-compute": 1.4},
    "process_cpu_s": 9.0}
WANT = {"step_launch_ms.decode": 8.0, "cache_copy_ms.decode": 3.0,
        "queue_wait_ms.decode": 8.0, "program_cpu_ms.decode": 200.0}


@pytest.mark.parametrize("name", READERS)
def test_a_reader_on_a_synthetic_run(name):
    from bench.harness import spec
    read = spec.metric(name).read
    assert read(_run(SYNTHETIC)) == pytest.approx(WANT[name])
    # a program that reports none of it (an older commit): nothing, no
    # exception
    parent = {"per_node": [{"compute_s": 0.1, "requests": 4}]}
    assert read(_run(parent)) is None and read(_run(None)) is None


def test_the_readers_read_a_tiny_decode_run():
    from bench.harness import load, spec
    c = tiny("starcoder2-3b.decode.closed8")
    import torch
    sut = spec.driver(c.config).build(c.config, c.traffic, 2**31 + 3,
                                      torch.device("cpu"), {})
    try:
        load.warm(sut, c.traffic, 2**31 + 3)
        run = load.drive(sut, load.Run(c.name, c.config, c.traffic, 1.0),
                         2**31 + 3)
    finally:
        sut.close()
    got = {m: spec.metric(m).read(run) for m in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert set(run.report["thread_cpu_s"]) >= {"defer-pump",
                                               "defer-collect"}


def _spans(origin, spans):
    from repro_torch.runtime.spans import Spans
    return Spans(origin, spans)


def _span(name, kind, a, b):
    from repro_torch.runtime.spans import Span
    return Span(name, kind, "t", a, b)


# perf_counter_ns 1_000 is Unix-epoch ns 5_000_000_000 on this log's clock
ORIGIN = (1_000, 5_000_000_000)
OFFSET = ORIGIN[1] - ORIGIN[0]


@pytest.mark.parametrize("off_ns,merged", [
    (0, True), (999_999, True), (-999_999, True), (1_000_001, False),
    (-2_000_000, False)])
def test_the_clock_mapping_and_its_1_ms_check(off_ns, merged):
    """The readings beside the mark, mapped, must land within 1 ms of the
    mark's ends; otherwise the spans are left out and the line says so."""
    from bench.harness.spans import merge
    from bench.harness.trace import Trace
    lo, hi = 6_000_000_000, 7_000_000_000
    trace = Trace(lo, hi, [], [])
    spans = _spans(ORIGIN, [_span("defer.pump", "work", lo - OFFSET + 10,
                                  lo - OFFSET + 20)])
    enter = (lo - OFFSET + off_ns, lo)
    exit_ = (hi - OFFSET, hi)
    err = io.StringIO()
    assert merge(trace, spans, enter, exit_, err) is merged
    line = json.loads(err.getvalue())["spans"]
    assert line["merged"] is merged and line["mapped_enter_ns"] == off_ns
    assert trace.host == ([("defer.pump", lo + 10, lo + 20)] if merged
                          else [])


def test_spans_are_clipped_to_the_window():
    from bench.harness.spans import merge
    from bench.harness.trace import Trace
    lo, hi = 6_000_000_000, 6_000_001_000
    trace = Trace(lo, hi, [], [])
    spans = _spans(ORIGIN, [
        _span("defer.s0.wave", "work", lo - OFFSET - 50, lo - OFFSET + 50),
        _span("defer.collect", "work", hi - OFFSET + 1, hi - OFFSET + 9)])
    merge(trace, spans, (lo - OFFSET, lo), (hi - OFFSET, hi), io.StringIO())
    assert trace.host == [("defer.s0.wave", lo, lo + 50)]


def test_idle_gaps_are_named_by_work_spans_never_by_wait_spans():
    """Two idle gaps of the card: one inside a step's sync, where a
    later-started wait span also lies; one where only a wait span lies.
    The first is the sync's; the second stays unnamed."""
    from bench.harness.spans import merge
    from bench.harness.trace import Trace
    lo = 6_000_000_000
    dev = [("k", lo, lo + 100), ("k", lo + 200, lo + 300),
           ("k", lo + 400, lo + 500)]
    trace = Trace(lo, lo + 500, dev, [])
    p = lo - OFFSET
    spans = _spans(ORIGIN, [
        _span("defer.s1.step.sync", "work", p + 90, p + 210),
        _span("defer.wait.s1.to_encode", "wait", p + 120, p + 190),
        _span("defer.wait.result", "wait", p + 290, p + 410)])
    assert merge(trace, spans, (p, lo), (p + 500, lo + 500), io.StringIO())
    assert dict(trace.idle_gaps()) == {
        "defer.s1.step.sync": 100 / 1e9,
        "host outside traced calls": 100 / 1e9}


def test_task_clocks_name_python_threads_and_count_their_cpu():
    from bench.harness.spans import task_cpu_s, tasks_window

    def burn():
        t = time.thread_time()
        while time.thread_time() - t < 0.05:
            pass
    before = task_cpu_s()
    stop = threading.Event()
    t = threading.Thread(target=lambda: (burn(), stop.wait(10)),
                         name="burner")
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        got = tasks_window(before, task_cpu_s())
        burned = [s for name, s in got.values() if name == "burner"]
        if burned and burned[0] >= 0.04:
            break
        time.sleep(0.01)
    stop.set()
    t.join(10)
    assert burned and burned[0] >= 0.04
    assert "MainThread" in {name for name, _ in got.values()}
