"""Run one cell of the benchmark once and print its result.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout on a machine with an NVIDIA card.  The cell
is an entry of ``BENCHMARK.json``; ``bench/harness/spec.py`` says where its
configuration, traffic mix and metrics live.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then ``checks``,
each compared number with its limit, which also end standard error.

Without CUDA, or with fewer cards than the cell asks for, it exits 2 and
prints no result.  Kernel builds go to the program's fixed build directory
inside the checkout, and any torch extension or Triton cache to
``.bench_cache/`` beside this folder.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)

    import torch

    from bench.harness import cell, spec
    c = spec.resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["tf32"])
    cell.measure(c, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
