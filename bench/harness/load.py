"""The one traffic generator: it reads a mix's parameters and drives the
system under test for the measured window.

A mix (``bench/traffic/<name>.json``) has a ``loop``:

* ``closed``: ``clients`` threads, each sending its next request (or
  opening its next session) when the last one has come back;
* ``poisson``: requests sent on a schedule at ``rate_per_s``, whatever is
  still in flight, from one sender thread, to ``clients`` client ids in
  turn; each request is timed from its scheduled send time, and the sender's
  lateness (send less schedule) is printed beside the result.

Every seed gets the same work.  The gaps of a Poisson schedule are the
quantiles of the exponential law at (j + 0.5) / N, in an order drawn from
the seed, so the window always holds the same N requests; sessions come in
rounds of one per client whose prompt and output lengths are spread evenly
over the mix's ranges, in a fixed order; the seed draws the images and
prompt tokens.  (A round's list is drawn anew by each client that
takes a session from it: a few milliseconds, against a session's seconds.)

After the window closes no new work starts; requests in flight are waited
for (a minute at most), and a session stops after the token it is waiting
for.  The engine's report is read once all of it is in.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

import numpy as np

DRAIN_S = 60.0


def stream_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one stream of draws of a run."""
    return int(np.random.default_rng([seed, stream]).integers(2**63 - 1))


@dataclasses.dataclass
class Request:
    index: int
    client: int
    sched: float                    # when it was due to be sent
    sent: float = 0.0               # when submit() was called
    done: float | None = None       # when its result came back
    out: Any = None
    error: str | None = None


@dataclasses.dataclass
class Session:
    index: int
    client: int
    prompt: list[int]
    new_tokens: int
    start: float = 0.0
    stamps: list[float] = dataclasses.field(default_factory=list)
    tokens: list[int] = dataclasses.field(default_factory=list)
    error: str | None = None

    @property
    def sid(self) -> str:
        return f"session-{self.index}"


@dataclasses.dataclass
class Run:
    """What one window produced, for the metric readers and the check."""
    cell: str
    config: dict
    traffic: dict
    seconds: float
    t0: float = 0.0
    t_end: float = 0.0              # t0 + seconds
    t_drained: float = 0.0
    requests: list[Request] = dataclasses.field(default_factory=list)
    sessions: list[Session] = dataclasses.field(default_factory=list)
    report: dict | None = None      # the engine's report over the window
    counters: dict = dataclasses.field(default_factory=dict)
    trace: Any = None               # harness.trace.Trace of a traced run
    cpu_s: float | None = None      # this process's CPU s, window and drain

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0


# -- plans ---------------------------------------------------------------------

def poisson_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Send offsets (s) of the N = floor(rate * seconds) requests: the
    exponential quantiles at (j + 0.5) / N, shuffled by the seed, summed."""
    n = int(rate * seconds)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    np.random.default_rng(stream_seed(seed, 3)).shuffle(gaps)
    return np.cumsum(gaps) - gaps[0]


def session_round(traffic: dict, seed: int, vocab: int, r: int
                  ) -> list[tuple[list[int], int]]:
    """(prompt, new tokens) of round ``r`` of sessions, one per client:
    session r * clients + c is client c's.  Lengths are the midpoints of
    ``clients`` equal strata of each range, paired in a fixed order, and
    client c takes pair (c + 3r) mod clients: the same work in the same
    order for every seed, which draws the tokens."""
    n = int(traffic["clients"])
    (p0, p1), (t0, t1) = traffic["prompt_len"], traffic["new_tokens"]
    plens = [int(p0 + (p1 - p0) * (j + 0.5) / n) for j in range(n)]
    tlens = [int(t0 + (t1 - t0) * (j + 0.5) / n) for j in range(n)]
    pairs = [(plens[j], tlens[(3 * j + 1) % n]) for j in range(n)]
    rng = np.random.default_rng([stream_seed(seed, 4), r])
    out = []
    for c in range(n):
        p, t = pairs[(c + 3 * r) % n]
        out.append((rng.integers(0, vocab, p).tolist(), t))
    return out


# -- driving ---------------------------------------------------------------------

def _closed_requests(sut, run: Run, clients: int, t_end: float) -> None:
    lock = threading.Lock()
    count = [0]

    def client(c: int) -> None:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            with lock:
                i = count[0]
                count[0] += 1
            r = Request(i, c, now, now)
            run.requests.append(r)
            try:
                r.out = sut.submit(sut.request_input(i), c).result(DRAIN_S)
                r.done = time.perf_counter()
            except Exception as e:      # noqa: BLE001 - recorded as failed
                r.error = repr(e)
                return

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(t_end - time.perf_counter() + DRAIN_S + 5)


def _poisson_requests(sut, run: Run, traffic: dict, seed: int, t0: float,
                      t_end: float) -> None:
    offsets = poisson_offsets(float(traffic["rate_per_s"]), run.seconds, seed)
    clients = int(traffic["clients"])
    futs = []
    for i, off in enumerate(offsets):
        due = t0 + float(off)
        if due >= t_end:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        r = Request(i, i % clients, due, time.perf_counter())
        run.requests.append(r)
        try:
            fut = sut.submit(sut.request_input(i), r.client)
        except Exception as e:          # noqa: BLE001 - recorded as failed
            r.error = repr(e)
            continue

        def finish(f, r=r):
            r.done = time.perf_counter()
            if f.exception() is not None:
                r.error = repr(f.exception())
                r.done = None
            else:
                r.out = f.result()
        fut.add_done_callback(finish)
        futs.append(fut)
    deadline = time.perf_counter() + DRAIN_S
    for f in futs:
        try:
            f.exception(max(0.0, deadline - time.perf_counter()))
        except TimeoutError:
            pass


def _closed_sessions(sut, run: Run, traffic: dict, seed: int) -> None:
    """Clients run sessions back to back from the window's start; each
    stops after the first token past its close."""
    clients = int(traffic["clients"])

    def client(c: int) -> None:
        r = 0
        while time.perf_counter() < run.t_end:
            prompt, n = session_round(traffic, seed, sut.vocab, r)[c]
            s = Session(r * clients + c, c, prompt, n,
                        start=time.perf_counter())
            r += 1
            run.sessions.append(s)
            gen = sut.generate(prompt, n, c, s.sid)
            try:
                for tok in gen:
                    s.stamps.append(time.perf_counter())
                    s.tokens.append(int(tok))
                    if s.stamps[-1] >= run.t_end:
                        break
            except Exception as e:      # noqa: BLE001 - recorded as failed
                s.error = repr(e)
                return
            finally:
                gen.close()

    _together([lambda _, c=c: client(c) for c in range(clients)],
              run.seconds + DRAIN_S + 5)


def _guarded(fn, arg, errors: list) -> None:
    try:
        fn(arg)
    except BaseException as e:          # noqa: BLE001 - re-raised by caller
        errors.append(e)


def drive(sut, run: Run, seed: int, tracer=None) -> Run:
    """Drive ``sut`` with ``run.traffic`` for ``run.seconds``; with a
    tracer, trace the window and the drain after it."""
    traffic = run.traffic
    if tracer is not None:
        tracer.start()
    sut.reset_window()
    cpu = time.process_time()
    run.t0 = time.perf_counter()
    run.t_end = run.t0 + run.seconds
    if sut.kind == "sessions":
        _closed_sessions(sut, run, traffic, seed)
    elif traffic["loop"] == "closed":
        _closed_requests(sut, run, int(traffic["clients"]), run.t_end)
    elif traffic["loop"] == "poisson":
        _poisson_requests(sut, run, traffic, seed, run.t0, run.t_end)
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    run.t_drained = time.perf_counter()
    run.cpu_s = time.process_time() - cpu
    if tracer is not None:
        run.trace = tracer.stop()
    run.report = sut.report()
    run.counters = sut.counters()
    return run


def _together(fns, timeout: float = 600) -> None:
    """Run the callables on threads of their own; raise the first error."""
    errors: list[BaseException] = []
    threads = [threading.Thread(target=_guarded, args=(fn, None, errors),
                                daemon=True) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"clients still running after {timeout} s")


def warm(sut, traffic: dict, seed: int) -> None:
    """The mix's warm-up (``warmup``) before the window: a fixed count of
    ``requests`` from ``clients`` closed-loop clients, or one round of
    sessions cut to ``new_tokens`` tokens each, on prompts of their own."""
    w = traffic["warmup"]
    if sut.kind == "sessions":
        plan = session_round(traffic, stream_seed(seed, 9), sut.vocab, 0)
        n = int(w["new_tokens"])
        _together([lambda _, p=p, c=c: list(
            sut.generate(p, n, c, f"warm-{c}"))
            for c, (p, _) in enumerate(plan)])
        return
    lock = threading.Lock()
    left = [int(w["requests"])]

    def client(c: int) -> None:
        while True:
            with lock:
                if left[0] <= 0:
                    return
                left[0] -= 1
                i = left[0]
            sut.submit(sut.request_input(i), c).result(DRAIN_S)

    _together([lambda _, c=c: client(c)
               for c in range(int(traffic["clients"]))])
