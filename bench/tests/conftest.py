"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src/`` on the path, one torch thread, and tiny versions of the cells."""
from __future__ import annotations

import copy
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for _p in (ROOT, os.path.join(ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

torch.set_num_threads(1)

# each configuration at a size the CPU runs in seconds, its depth, heads
# and wire kept; the limits stay those of the cell but q8's: at 32 x 32 the
# wire's rounding at the cuts moves the logits far more than at 224 (the
# program reads 4.8e-4 to 6.0e-3 over six seeds, TF32's control 1.0e-2 to
# 1.3e-2), so a tiny q8 run checks the path and the faults, not TF32
TINY = {
    "cnn_chain": {"model": {"image": 32, "num_classes": 1000},
                  "limits": {"q8": {"logits_rel_err": 0.02}}},
    "lm_chain": {"model": {"vocab": 512, "d_model": 64, "n_layers": 4,
                           "num_heads": 4, "kv_heads": 2, "head_dim": 16,
                           "d_ff": 128, "cache_len": 128},
                 "serve": {"cuts": [3, 5, 7]}},
}
TINY_TRAFFIC = {"lm_chain": {"prompt_len": [8, 32], "new_tokens": [4, 12]}}


def tiny(name: str, **traffic):
    """The cell ``name`` of BENCHMARK.json with a tiny configuration, its
    mix's keys replaced by ``traffic`` (``wire="raw"``: the raw wire)."""
    from bench.harness import spec
    c = spec.resolve(name, ROOT)
    cfg = copy.deepcopy(c.config)
    for k, v in TINY[cfg["driver"]].items():
        cfg[k].update(v)
    c.config = cfg
    c.traffic = dict(c.traffic, **TINY_TRAFFIC.get(cfg["driver"], {}),
                     **traffic)
    return c


def run_tiny(cell, seconds: float = 2.0, seed: int = 2**31 + 7) -> dict:
    """One run of ``cell`` on the CPU; the result line as a dict."""
    from bench.harness import cell as cell_mod
    out, err = io.StringIO(), io.StringIO()
    cell_mod.measure(cell, seed, seconds, False, torch.device("cpu"),
                     time.perf_counter(), out=out, err=err)
    return json.loads(out.getvalue().strip().splitlines()[-1])
