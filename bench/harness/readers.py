"""What the metric readers share: samples of the window, the engine's
per-stage figures, and the device's share of the traced window."""
from __future__ import annotations

import numpy as np

# device operations that are copies or sets, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")


def p95_ms(values: list[float]) -> float | None:
    return float(np.percentile(values, 95) * 1e3) if values else None


def latencies(run) -> list[float]:
    """Send (or scheduled send) to result, of every request of the window
    that came back."""
    return [r.done - r.sched for r in run.requests if r.done is not None]


def answered_in_window(run) -> int:
    return sum(1 for r in run.requests
               if r.done is not None and r.done <= run.t_end)


def stage_sum(run, per_replica) -> float | None:
    """Sum over stages of ``per_replica(node)``, each stage's replicas
    weighted by the requests they served."""
    nodes = (run.report or {}).get("per_node", [])
    if not any(n["requests"] for n in nodes):
        return None
    total = 0.0
    for stage in sorted({n["stage"] for n in nodes}):
        reps = [n for n in nodes if n["stage"] == stage and n["requests"]]
        served = sum(n["requests"] for n in reps)
        total += sum(per_replica(n) * n["requests"] for n in reps) / served
    return total


def idle_pct(run) -> float | None:
    t = run.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def kernels(run) -> int:
    return sum(1 for n, _, _ in run.trace.device
               if not n.startswith(_NOT_KERNELS))


def roofline_pct(run, pattern: str, bound_s: float) -> float | None:
    """Bound over device time of the operations matching ``pattern``."""
    if run.trace is None:
        return None
    spent, launches = run.trace.device_s(pattern)
    if not launches or spent <= 0:
        return None
    return 100.0 * bound_s / spent
