"""The device trace of a window: ``torch.profiler``'s raw events, read
without building its tables (which take minutes for a decode window).

A :class:`Trace` holds the device's operations (kernels, copies, sets) and
the host's operator spans, all clipped to the traced window, on the
profiler's own clock.  Busy time is the union of the device intervals, so
operations that overlap on several streams count once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import re
from collections import defaultdict

WINDOW_MARK = "bench.window"


def union_s(intervals: list[tuple[int, int]]) -> float:
    """Seconds covered by at least one of the [start, end) intervals (ns)."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def gaps(intervals: list[tuple[int, int]], lo: int, hi: int
         ) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    start_ns: int
    end_ns: int
    device: list[tuple[str, int, int]]      # (name, start, end), clipped
    host: list[tuple[str, int, int]]        # operator spans on the host

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.device])

    def device_s(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of the device operations whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [(a, b) for n, a, b in self.device if rx.search(n)]
        return sum(b - a for a, b in hits) / 1e9, len(hits)

    def top_ops(self, k: int = 10) -> list[list]:
        by = defaultdict(int)
        for n, a, b in self.device:
            by[n] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], s / 1e9] for n, s in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """Idle time of the device summed by what the host was doing: the
        innermost (latest started) host span that covers the middle of each
        gap, or ``host outside traced calls``."""
        spans = sorted(self.host, key=lambda e: e[1])
        mids = sorted(((a + b) // 2, b - a) for a, b in gaps(
            [(x, y) for _, x, y in self.device], self.start_ns, self.end_ns))
        by: dict[str, int] = defaultdict(int)
        heap: list[tuple[int, int, str]] = []
        i = 0
        for mid, length in mids:
            while i < len(spans) and spans[i][1] <= mid:
                n, x, y = spans[i]
                heapq.heappush(heap, (-x, y, n))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            by[heap[0][2] if heap else "host outside traced calls"] += length
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], s / 1e9] for n, s in top]


class Tracer:
    """Profiles the device and the host's operators between ``start`` and
    ``stop``; ``stop`` returns the :class:`Trace`."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._mark: contextlib.AbstractContextManager | None = None

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self._prof.__enter__()
        self._mark = self._torch.profiler.record_function(WINDOW_MARK)
        self._mark.__enter__()

    def stop(self) -> Trace:
        self._torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        return read_events(self._prof.profiler.kineto_results.events())


def read_events(events) -> Trace:
    """A :class:`Trace` from kineto events: the window is the span of the
    ``bench.window`` mark."""
    dev, host, win = [], [], None
    for e in events:
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        on_card = str(e.device_type()).endswith("CUDA")
        if name == WINDOW_MARK:
            # the mark's mirror on the card (kineto draws one over the
            # kernels its thread launched) is no operation
            if not on_card:
                win = (a, b)
        elif on_card:
            dev.append((name, a, b))
        elif e.duration_ns() > 0:
            host.append((name, a, b))
    if win is None:
        raise RuntimeError("the trace has no window mark")
    lo, hi = win

    def clip(evs):
        return [(n, max(a, lo), min(b, hi)) for n, a, b in evs
                if b > lo and a < hi]
    return Trace(lo, hi, clip(dev), clip(host))
