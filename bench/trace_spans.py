"""Run one cell once, traced, with the program's span log on.

    python3 bench/trace_spans.py --workload NAME --seed N --seconds S

run from the root of a checkout on a machine with an NVIDIA card.  It runs
the cell as ``bench/run.py --trace 1`` does and prints the same result
line, with two differences: the engine's span log records from the
window's start, and the spans, put on the trace's clock, join its host
spans, so the breakdown's idle gaps name the program's work
(``defer.s1.step.sync``, ``defer.route.s0``, ...) where the host was
outside any CUDA call.  Standard error adds, one JSON object a line:

* ``spans``: whether the spans were merged, and how far the two clocks read
  beside the window mark land from its ends (more than 1 ms: left out);
* ``idle``: the device's idle seconds in the window, and all of them by
  what names them (``host outside traced calls``: nothing the trace or
  the program recorded);
* ``span_s``: the seconds each span name covers in the window;
* ``cpu``: CPU seconds over the window of each of the chain's threads (the
  engine's ``thread_cpu_s``), of the clients' threads, of every other live
  thread of the process by name, and of the process
  (``process_cpu_s``);
* ``end_to_end``: the cell's end-to-end metrics read from this traced run
  (the profiler's cost included).

Where the checkout's program has no span log (an older commit), the run
goes on without spans, so two commits can be compared with tracing on.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with_client_clocks(together, cpu: list):
    """``load._together`` whose threads each add their CPU seconds to
    ``cpu`` as they end (client threads end inside the window, before any
    reading of live threads could see them)."""
    def run(fns, timeout=600):
        def clocked(fn):
            def call(arg):
                try:
                    fn(arg)
                finally:
                    cpu.append(time.thread_time())
            return call
        return together([clocked(fn) for fn in fns], timeout)
    return run


def run_cell(c, seed: int, seconds: float, device, out=sys.stdout,
             err=sys.stderr) -> dict:
    """One traced run of cell ``c`` with the span log on; the result."""
    from bench.harness import cell, load, spec, trace
    from bench.harness import spans as S
    got: dict = {"clients": []}
    drive = load.drive

    def spanned_drive(sut, run, seed, tracer=None):
        eng = sut.eng
        logs = hasattr(eng, "start_spans")
        reset = sut.reset_window

        def reset_window():
            reset()
            got["tasks"] = S.task_cpu_s()
            if logs:
                eng.start_spans()
        sut.reset_window = reset_window
        load._together = _with_client_clocks(load._together, got["clients"])
        drive(sut, run, seed, tracer)
        tasks = S.tasks_window(got["tasks"], S.task_cpu_s())
        chain = {t.native_id for t in eng.threads()} if logs else set()
        other: dict[str, float] = {}
        for tid, (name, s) in tasks.items():
            if tid not in chain:
                other[name] = other.get(name, 0.0) + s
        report = run.report or {}
        named = report.get("thread_cpu_s", {})
        process = report.get("process_cpu_s")
        clients = sum(got["clients"])
        print(json.dumps({"cpu": {
            "thread_cpu_s": named, "clients_s": clients,
            "other_threads_s": dict(sorted(other.items(),
                                           key=lambda kv: -kv[1])),
            "process_cpu_s": process,
            # threads that ended in the window unclocked (a request
            # cell's clients), and rounding of the tick-counted threads
            "rest_s": (None if process is None else process - clients
                       - sum(named.values()) - sum(other.values()))}}),
              file=err)
        if logs:
            spans = eng.stop_spans()
            S.merge(run.trace, spans, tracer.enter, tracer.exit, err)
            print(json.dumps({"span_s": S.span_totals(spans, run.trace)}),
                  file=err)
        print(json.dumps({"idle": {
            "idle_s": run.trace.window_s - run.trace.busy_s(),
            "by": dict(run.trace.idle_gaps(k=10**6))}}), file=err)
        e2e = {m["name"]: spec.metric(m["name"]).read(run)
               for m in c.end_to_end if m["name"] != "setup_s"}
        print(json.dumps({"end_to_end": e2e}), file=err)
        return run

    saved = load._together, trace.Tracer
    load.drive, trace.Tracer = spanned_drive, S.MarkedTracer
    try:
        return cell.measure(c, seed, seconds, True, device, T_START,
                            out=out, err=err)
    finally:
        load.drive = drive
        load._together, trace.Tracer = saved


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from bench.harness import spec
    c = spec.resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["tf32"])

    run_cell(c, args.seed, args.seconds, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
