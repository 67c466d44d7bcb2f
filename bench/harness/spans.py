"""The program's own spans and thread clocks, beside the device trace.

The engine's report carries window totals that the per-layer readers use
(``per_token_ms``, ``replica_sum``).  ``bench/trace_spans.py`` goes further
in a traced run: it starts the engine's span log with the window, puts the
spans on the trace's clock (``merge``), so that the breakdown's idle gaps
name what the program's threads were doing, and splits the process's CPU
by thread (``task_cpu_s``).

The profiler stamps its events in Unix-epoch ns.  A span log hands over the
(``perf_counter_ns``, ``time_ns``) pair it read at start, which maps its
spans there.  ``MarkedTracer`` reads both clocks beside the window mark's
enter and exit; the mapping is used only where it puts those readings
within ``TOLERANCE_NS`` of the mark's own ends.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from bench.harness.trace import WINDOW_MARK, Trace, Tracer

TOLERANCE_NS = 1_000_000


def tokens(run) -> int:
    """Tokens served, window and drain (all of a window's sessions)."""
    return sum(len(s.tokens) for s in run.sessions)


def per_token_ms(run, seconds: float | None) -> float | None:
    n = tokens(run)
    if seconds is None or not n:
        return None
    return seconds * 1e3 / n


def replica_sum(run, key: str) -> float | None:
    """The engine's per-replica ``key`` summed over replicas, or None where
    the program reports no such key."""
    nodes = [n for n in (run.report or {}).get("per_node", []) if key in n]
    return sum(n[key] for n in nodes) if nodes else None


class MarkedTracer(Tracer):
    """A :class:`Tracer` that reads (``perf_counter_ns``, ``time_ns``) just
    before the window mark enters and just before it exits."""

    def start(self) -> None:
        # Tracer.start with the reading between the profiler's start and
        # the mark's enter (the mark stamps its start as it enters)
        self._torch.cuda.synchronize()
        self._prof.__enter__()
        self._mark = self._torch.profiler.record_function(WINDOW_MARK)
        self.enter = (time.perf_counter_ns(), time.time_ns())
        self._mark.__enter__()

    def stop(self) -> Trace:
        # the card first, so that the mark exits right after the reading
        self._torch.cuda.synchronize()
        self.exit = (time.perf_counter_ns(), time.time_ns())
        return super().stop()


def clock_offsets(trace: Trace, spans, enter: tuple[int, int],
                  exit_: tuple[int, int]) -> dict:
    """How far the two readings beside the mark land from its ends (ns):
    mapped from ``perf_counter_ns`` by ``spans``, and read from
    ``time_ns``."""
    return {"mapped_enter_ns": spans.wall_ns(enter[0]) - trace.start_ns,
            "mapped_exit_ns": spans.wall_ns(exit_[0]) - trace.end_ns,
            "time_ns_enter_ns": enter[1] - trace.start_ns,
            "time_ns_exit_ns": exit_[1] - trace.end_ns}


def merge(trace: Trace, spans, enter: tuple[int, int],
          exit_: tuple[int, int], err=sys.stderr) -> bool:
    """Add ``spans``' work spans, on the trace's clock and clipped to its
    window, to ``trace.host``, where the mapping puts the readings beside
    the mark within ``TOLERANCE_NS`` of its ends; else leave them out.
    Wait spans are never added: a queue's wait is no work of the host.
    Prints one line on ``err`` either way."""
    off = clock_offsets(trace, spans, enter, exit_)
    ok = all(abs(off[k]) <= TOLERANCE_NS
             for k in ("mapped_enter_ns", "mapped_exit_ns"))
    added = 0
    if ok:
        lo, hi = trace.start_ns, trace.end_ns
        for s in spans.spans:
            if s.kind != "work":
                continue
            a, b = spans.wall_ns(s.start_ns), spans.wall_ns(s.end_ns)
            if b > lo and a < hi:
                trace.host.append((s.name, max(a, lo), min(b, hi)))
                added += 1
    print(json.dumps({"spans": {"merged": ok, "added": added,
                                "recorded": len(spans.spans), **off}}),
          file=err)
    return ok


def span_totals(spans, trace: Trace | None = None) -> dict[str, float]:
    """Seconds each span name covers (summed over its spans), clipped to
    the trace's window where one is given."""
    out: dict[str, float] = {}
    for s in spans.spans:
        a, b = spans.wall_ns(s.start_ns), spans.wall_ns(s.end_ns)
        if trace is not None:
            a, b = max(a, trace.start_ns), min(b, trace.end_ns)
        if b > a:
            out[s.name] = out.get(s.name, 0.0) + (b - a) / 1e9
    return out


def _task_s(tid: str) -> tuple[str, float] | None:
    base = f"/proc/self/task/{tid}"
    try:
        with open(f"{base}/stat") as f:
            stat = f.read()
    except OSError:
        return None
    name = stat[stat.index("(") + 1:stat.rindex(")")]
    try:
        with open(f"{base}/schedstat") as f:
            return name, int(f.read().split()[0]) / 1e9
    except (OSError, ValueError, IndexError):
        fields = stat[stat.rindex(")") + 2:].split()
        return name, (int(fields[11]) + int(fields[12])) \
            / os.sysconf("SC_CLK_TCK")


def task_cpu_s() -> dict[int, tuple[str, float]]:
    """Every live thread of this process by kernel task id: its name (the
    Python thread's where it is one, else the kernel's) and its CPU
    seconds so far (``/proc/self/task``, in ns where the kernel keeps
    ``schedstat``, else in clock ticks)."""
    py = {t.native_id: t.name for t in threading.enumerate()}
    out = {}
    for tid in os.listdir("/proc/self/task"):
        got = _task_s(tid)
        if got is not None:
            out[int(tid)] = (py.get(int(tid), got[0]), got[1])
    return out


def tasks_window(before: dict, after: dict) -> dict[int, tuple[str, float]]:
    """CPU seconds of each live task between two :func:`task_cpu_s`
    readings (a task born between them counts from its start)."""
    return {tid: (name, s - before.get(tid, (name, 0.0))[1])
            for tid, (name, s) in after.items()}
