"""Read a cell's control beside the program's own reading, on several seeds.

    python3 bench/control.py --workload NAME --seeds 1,2,3 --seconds S

Each seed runs the cell once as ``run.py`` does (set-up, a window of ``S``
seconds, the check) and then the control: the plain reference one
precision below what the configuration states (TF32 for f32) in the
program's place, serving the same window's requests, judged by the check's
own comparison and limits.  It prints the control's checks on a line of
its own and exits 1 if any control came out correct.  A limit lies between
the program's readings and the control's; see PERF.md.  The benchmark's
own runs never run the control.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for p in (ROOT, os.path.join(ROOT, "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from bench.harness import cell, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    c = spec.resolve(args.workload, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["tf32"])
    passed = []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = cell.measure(c, seed, args.seconds, False,
                           torch.device("cuda", 0), time.perf_counter(),
                           control=True)
        if res["control"]["correct"]:
            passed.append(seed)
    if passed:
        print(f"the control came out correct on seeds {passed}",
              file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
