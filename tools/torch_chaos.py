"""Fault-injection harness for the port's supervised process-per-replica
serving.

The twin of ``tools/chaos.py`` on the PyTorch port: wraps a
:class:`~repro_torch.runtime.supervisor.Supervisor` with the three
fault primitives the chaos tests (and any manual resilience drill) need:

* :meth:`Chaos.kill` — SIGKILL a worker process (the paper's "device
  died" case: no goodbye, batches in its pipeline are simply gone);
* :meth:`Chaos.hang_compute` / :meth:`Chaos.slow_compute` — wedge or
  dilate a worker's compute stage *while its heartbeat stays healthy*
  (the failure mode liveness-by-heartbeat cannot see, and the one
  stall detection exists for);
* :meth:`Chaos.sever` — kill a worker's data sockets mid-batch while
  the process itself stays up (a flaky link, not a dead device).

Plus event-log helpers (:meth:`wait_event`) so tests assert on the
supervisor's audit trail — "a death was recorded, then a respawn" —
instead of sleeping and hoping.  ``hang``/``slow``/chaos frames require
the workers to have been spawned with ``--chaos``
(``SupervisorConfig(allow_chaos=True)``); production spawns ignore them.
"""
from __future__ import annotations

import os
import signal
import threading
import time

from repro_torch.runtime.wire import ControlFrame


class Chaos:
    """Fault injector bound to one supervisor."""

    def __init__(self, supervisor):
        self.sup = supervisor
        self._tick = threading.Event()

    # -- victim selection ------------------------------------------------------
    def workers(self, stage: int | None = None) -> list:
        """Live (non-dead, spawned) worker handles, optionally one stage's."""
        with self.sup._lock:
            handles = list(self.sup._handles)
        return [h for h in handles
                if not h.dead and h.proc is not None
                and h.proc.poll() is None
                and (stage is None or h.index == stage)]

    def pick(self, stage: int | None = None):
        """First live worker (of ``stage``); raises if none survive."""
        victims = self.workers(stage)
        if not victims:
            raise LookupError(f"no live worker to target (stage={stage})")
        return victims[0]

    # -- fault primitives ------------------------------------------------------
    def kill(self, handle) -> int:
        """SIGKILL the worker: no drain, no goodbye, batches inside its
        pipeline are lost.  Returns the victim pid."""
        pid = handle.proc.pid
        os.kill(pid, signal.SIGKILL)
        return pid

    def hang_compute(self, handle) -> None:
        """Wedge the worker's compute stage forever.  Its heartbeat
        thread stays perfectly healthy — only OS reaping won't fire and
        only stall detection can page."""
        handle._control_send(
            ControlFrame("chaos", {"action": "hang_compute"}), required=True)

    def slow_compute(self, handle, delay_s: float = 0.05) -> None:
        """Dilate every apply by ``delay_s`` — a slow-but-alive worker
        (kills must land mid-batch; failure detection must NOT page)."""
        handle._control_send(
            ControlFrame("chaos", {"action": "slow_compute",
                                   "delay_s": delay_s}), required=True)

    def hang_stage(self, stage: int) -> int:
        """Wedge EVERY live worker of one stage (no healthy sibling to
        route around — the deadline drills need the whole stage dark).
        Returns how many workers were hung."""
        victims = self.workers(stage)
        for h in victims:
            self.hang_compute(h)
        return len(victims)

    def slow_stage(self, stage: int, delay_s: float = 0.05) -> int:
        """Dilate every live worker of one stage (kills land mid-batch)."""
        victims = self.workers(stage)
        for h in victims:
            self.slow_compute(h, delay_s)
        return len(victims)

    def sever(self, handle) -> None:
        """Cut the worker's data sockets mid-batch, process left running:
        a dead link, not a dead device.  The routers see a dead channel
        and heal exactly as for a crash; the supervisor's monitor then
        reaps the orphaned process when its heartbeat socket dies or the
        stage respawns over it."""
        handle.kill_links()

    # -- event-log assertions --------------------------------------------------
    def events(self, kind: str | None = None,
               stage: int | None = None) -> list[dict]:
        with self.sup._lock:
            evs = list(self.sup.events)
        return [e for e in evs
                if (kind is None or e["kind"] == kind)
                and (stage is None or e.get("stage") == stage)]

    def wait_event(self, kind: str, stage: int | None = None,
                   count: int = 1, timeout: float = 30.0) -> list[dict]:
        """Block until the supervisor's audit trail holds ``count``
        events of ``kind`` (for ``stage``), or raise TimeoutError with
        the trail so far — chaos tests assert on recorded facts, not on
        sleeps."""
        deadline = time.monotonic() + timeout
        while True:
            got = self.events(kind, stage)
            if len(got) >= count:
                return got
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no {count}x {kind!r} (stage={stage}) within "
                    f"{timeout}s; events so far: "
                    f"{[e['kind'] for e in self.events()]}")
            self._tick.wait(0.05)

    def wait_respawn(self, stage: int, count: int = 1,
                     timeout: float = 30.0) -> list[dict]:
        return self.wait_event("respawn", stage, count, timeout)

    def wait_death(self, stage: int, count: int = 1,
                   timeout: float = 30.0) -> list[dict]:
        return self.wait_event("death", stage, count, timeout)

    def wait_stage_full(self, dispatcher, stage: int,
                        timeout: float = 30.0) -> int:
        """Block until ``stage`` is back to its topology target replica
        count (post-respawn convergence)."""
        deadline = time.monotonic() + timeout
        while True:
            target = dispatcher.topology.stages[stage].replicas
            live = [r for r in dispatcher.stages[stage].live_replicas()
                    if not r.retiring]
            if len(live) >= target:
                return len(live)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"stage {stage} stuck at {len(live)}/{target} replicas")
            self._tick.wait(0.05)
