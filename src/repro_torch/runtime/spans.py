"""Spans of the serving chain, on a clock that maps onto a device trace's.

A :class:`SpanLog` is off until :meth:`SpanLog.start`.  Off, every span
boundary in the chain is one attribute check (``log.on``), and
:meth:`SpanLog.span` hands back one shared null context: nothing is
allocated or recorded.  On, each span records its name, its kind
(``work``, or ``wait`` for the time an item sat in a queue between its put
and its take), the thread it ran on, its start and end on
``time.perf_counter_ns``'s clock, the request and session ids it covers,
and its stage and replica (-1 where it has none).  :meth:`SpanLog.stop`
hands the spans over with the (``perf_counter_ns``, ``time_ns``) pair read
at start, so a reader can put them on the Unix-epoch clock that
``torch.profiler`` stamps its events with.

The chain records, with ``i`` the stage index:

* work: ``defer.submit``, ``defer.pump`` (one admission item sent to the
  head), ``defer.route.s{i}`` (one envelope routed), ``defer.s{i}.decode``
  (a wave's codec decodes), ``defer.s{i}.step.hold`` (a wave of decode
  steps held for its bank's due residents, just before it is computed),
  ``defer.s{i}.wave`` (one merged wave computed),
  inside it ``defer.s{i}.compute`` (a stacked apply of plain traffic),
  ``defer.s{i}.prefill`` (one session open, its copy to the host included)
  and a decode step's ``defer.s{i}.step.stack`` (caches stacked, tokens and
  positions copied in), ``.step.launch`` (the step apply up to its return),
  ``.step.sync`` (its logits copied out, which waits for the card) and
  ``.step.unstack`` (each row's caches cut out and stored); then
  ``defer.s{i}.encode``, ``defer.s{i}.relay`` and ``defer.collect`` (one
  tail item decoded and its futures resolved);
* wait: ``defer.wait.admission``, ``defer.wait.s{i}.inbox`` (from the send
  into the stage's input, through its router, to the replica's ingress),
  ``defer.wait.s{i}.to_compute``, ``defer.wait.s{i}.to_encode`` and
  ``defer.wait.result``.

Only spans of this process are recorded: a process-backed replica's own
threads record none.

Whether the log is on or off, the same readings feed the window totals of
the engine's report: each replica's decode-step phases, its prefills'
seconds and prompt tokens (``prefill_s``, ``prefill_tokens``: its
``defer.s{i}.prefill`` spans), its waves' holds (``step_hold_s``: its
``defer.s{i}.step.hold`` spans; ``step_holds``, ``step_hold_joins``), and the decode steps' waits in each queue
(:func:`waited`).  A replica's routed-expert blocks count on the device,
inside each step and so inside its CUDA graph, the live rows routed to
each held expert (``moe_rows``, by layer) and the assignments to held
experts that the combine weights by 0 (``moe_dropped``); the report reads them at
the window's reset and at its end, never inside it.  :func:`thread_cpu_s` reads
the CPU clocks of a set of threads, for its CPU by thread over the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterable

from repro_torch.runtime.wire import K_STEP

WORK = "work"
WAIT = "wait"

# the context every span boundary gets while the log is off
NULL = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    kind: str                   # WORK or WAIT
    thread: str
    start_ns: int               # time.perf_counter_ns's clock
    end_ns: int
    ids: tuple = ()             # request ids it covers
    sessions: tuple = ()        # session ids it covers
    stage: int = -1
    replica: int = -1


@dataclasses.dataclass
class Spans:
    """What one :meth:`SpanLog.stop` hands over."""

    origin: tuple[int, int]     # (perf_counter_ns, time_ns) read at start
    spans: list[Span]

    def wall_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the Unix-epoch clock."""
        return self.origin[1] + perf_ns - self.origin[0]


def _ids(extents) -> tuple[tuple, tuple]:
    return (tuple(e.request_id for e in extents),
            tuple(e.session for e in extents if e.session is not None))


class _Timed:
    """An open span: reads the clock at enter and records at exit."""

    __slots__ = ("log", "name", "extents", "stage", "replica", "t0")

    def __init__(self, log: "SpanLog", name: str, extents, stage: int,
                 replica: int):
        self.log, self.name, self.extents = log, name, extents
        self.stage, self.replica = stage, replica

    def __enter__(self) -> "_Timed":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.log.add(self.name, self.t0, time.perf_counter(),
                     extents=self.extents, stage=self.stage,
                     replica=self.replica)


class SpanLog:
    """The chain's span log: one per dispatcher, shared by its replicas
    and routers.  Off by default."""

    def __init__(self):
        self.on = False
        self._spans: list[Span] = []
        self._origin = (0, 0)

    def start(self) -> None:
        """Drop whatever was recorded and record from now on."""
        self._spans = []
        self._origin = (time.perf_counter_ns(), time.time_ns())
        self.on = True

    def stop(self) -> Spans:
        """Stop recording; hand over the spans recorded since start."""
        self.on = False
        spans, self._spans = self._spans, []
        return Spans(self._origin, spans)

    def span(self, name: str, extents: Iterable = (), stage: int = -1,
             replica: int = -1):
        """A work span around a ``with`` block (the shared null context
        while the log is off)."""
        if not self.on:
            return NULL
        return _Timed(self, name, extents, stage, replica)

    def add(self, name: str, t0: float, t1: float, kind: str = WORK,
            extents: Iterable = (), stage: int = -1,
            replica: int = -1) -> None:
        """Record one span from two ``time.perf_counter`` readings that the
        caller already took around the work (or the put and the take)."""
        ids, sessions = _ids(extents)
        self._spans.append(Span(
            name, kind, threading.current_thread().name,
            round(t0 * 1e9), round(t1 * 1e9), ids, sessions, stage,
            replica))


def thread_cpu_s(threads: Iterable[threading.Thread]
                 ) -> dict[threading.Thread, float]:
    """CPU seconds so far of each live thread of ``threads`` (an exited
    thread's clock cannot be read, so it is left out)."""
    out = {}
    for t in threads:
        if t.ident is None or not t.is_alive():
            continue
        try:
            out[t] = time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except OSError:
            pass            # it exited since the check
    return out


def window_cpu_s(base: dict[threading.Thread, float],
                 now: dict[threading.Thread, float]) -> dict[str, float]:
    """CPU seconds each thread spent between two :func:`thread_cpu_s`
    readings, by thread name; a thread started after ``base`` counts from
    its start."""
    out: dict[str, float] = {}
    for t, s in now.items():
        out[t.name] = out.get(t.name, 0.0) + s - base.get(t, 0.0)
    return out


def waited(log: SpanLog, name: str, t_put: float, extents,
           stage: int = -1, replica: int = -1) -> float:
    """Close the wait of an item taken off a queue now, ``t_put`` the
    stamp its put left on it: a wait span while the log is on.  Returns
    the wait times the decode steps among ``extents``, for the window's
    totals; 0 for an item with no stamp (one that crossed a socket, whose
    framing carries none)."""
    if not t_put:
        return 0.0
    now = time.perf_counter()
    if log.on:
        log.add(name, t_put, now, WAIT, extents, stage, replica)
    return (now - t_put) * sum(1 for e in extents if e.kind == K_STEP)
