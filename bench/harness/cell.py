"""One run of one cell: set up, warm up, measure, check, report.

Set-up (``setup_s``) runs from the start of the process to the start of
the window: drawing the weights and inputs, configuring and warming the
engine, and the mix's warm-up traffic.  Its parts print on a line of their
own on standard error, with the reference's time after the window, which
is not part of it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from bench.harness import load, spec
from bench.harness.result import emit_checks, line

# top-level module names that may not be loaded in the run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, out=sys.stdout,
            err=sys.stderr, control: bool = False) -> dict:
    """Run ``cell`` once; print the setup line and the checks on ``err``
    and the result line on ``out``; return the result.  With ``control``
    (never in the benchmark's own runs) also print the control's checks
    over the same window, judged by the run's own comparison and limits,
    on a line before the result."""
    setup: dict = {}
    drv = spec.driver(cell.config)
    sut = drv.build(cell.config, cell.traffic, seed, device, setup)
    tracer = None
    if trace:
        from bench.harness.trace import Tracer
        tracer = Tracer()
    t = time.perf_counter()
    load.warm(sut, cell.traffic, seed)
    run = load.Run(cell.name, cell.config, cell.traffic, seconds)
    try:
        load.drive(sut, run, seed, tracer)
    finally:
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        sut.close()
    setup["warmup_s"] = run.t0 - t
    setup_s = run.t0 - t_start
    t = time.perf_counter()
    checks = sut.check(run)
    setup["reference_s (after the window)"] = time.perf_counter() - t
    ctl = None
    if control:
        checked = sut.control(run)
        ctl = {"correct": all(c.ok for c in checked),
               "checks": {c.name: {"value": c.value, "limit": c.limit}
                          for c in checked}}
        print(json.dumps({"control": ctl, "cell": cell.name, "seed": seed}),
              file=out)
    setup["setup_s"] = setup_s
    print(json.dumps({"setup": setup}), file=err)
    print(json.dumps({"host_cpu_s": run.cpu_s}), file=err)
    late = [r.sent - r.sched for r in run.requests]
    if cell.traffic["loop"] == "poisson" and late:
        print(json.dumps({"sender_late_ms": {
            "p95": float(np.percentile(late, 95) * 1e3),
            "max": float(max(late) * 1e3)}}), file=err)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m["name"] == "setup_s":
            v = setup_s
        else:
            v = spec.metric(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    items = ([s for s in run.sessions if s.start >= run.t0
              or any(t >= run.t0 for t in s.stamps)]
             if run.sessions else run.requests)
    failed = sum(1 for r in items if r.error is not None
                 or getattr(r, "done", 0) is None)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    breakdown = None
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        breakdown = {"device_ops": run.trace.top_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of the JAX package loaded: {bad}")
    correct = all(c.ok for c in checks)
    text = line(correct, len(items), failed, metrics, dev, checks, breakdown)
    print(text, file=out)
    out.flush()
    emit_checks(checks, err)
    res = json.loads(text)
    if ctl is not None:
        res["control"] = ctl
    return res
