"""Find the highest rate a request cell's chain sustains, for an open-loop
mix: Poisson arrivals at each given rate, one window each, in one process.

    python3 bench/sweep.py --workload NAME --rates 20,26,32 --seconds 20 \
        --seed N

The cell's configuration and wire are used; its loop is replaced by
``poisson`` at each rate in turn (``clients`` ids as in its mix).  One line
a rate: requests sent and answered, the median latency in each third of
the window, the 95th percentile, how long the backlog took to drain after
the window, and the sender's lateness.  A rate is sustained where the
thirds' medians do not grow and the drain is short; an open-loop cell
offers about four fifths of the highest such rate.  The benchmark's own
runs never run the sweep.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import numpy as np
    import torch

    from bench.harness import load, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    c = spec.resolve(args.workload, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = bool(c.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(c.config["tf32"])
    sut = spec.driver(c.config).build(c.config, c.traffic, args.seed,
                                      torch.device("cuda", 0), {})
    try:
        load.warm(sut, c.traffic, args.seed)
        secs = args.seconds
        for rate in (float(r) for r in args.rates.split(",")):
            traffic = dict(c.traffic, loop="poisson", rate_per_s=rate)
            run = load.Run("sweep", c.config, traffic, secs)
            load.drive(sut, run, args.seed + int(rate * 1000), None)
            done = [(r.sched - run.t0, r.done - r.sched)
                    for r in run.requests if r.done is not None]
            thirds = [[lat for t, lat in done
                       if k * secs / 3 <= t < (k + 1) * secs / 3]
                      for k in range(3)]
            late = [r.sent - r.sched for r in run.requests]
            print(json.dumps({
                "rate": rate, "sent": len(run.requests),
                "answered": len(done),
                "p50_thirds_ms": [float(np.median(t) * 1e3) if t else None
                                  for t in thirds],
                "p95_ms": (float(np.percentile([lat for _, lat in done], 95)
                                 * 1e3) if done else None),
                "drain_s": run.t_drained - run.t_end,
                "sender_late_p95_ms": float(np.percentile(late, 95) * 1e3),
                "sender_late_max_ms": float(max(late) * 1e3)}), flush=True)
    finally:
        sut.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
