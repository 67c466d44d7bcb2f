"""Shared utilities of the port's benchmarks: CSV emission + graph cache.

The twin of ``benchmarks/common.py`` over ``repro_torch``: it imports
neither ``jax`` nor the reference package.
"""
from __future__ import annotations

import functools
import os

ART = os.environ.get("REPRO_ARTIFACTS", "artifacts")


def emit(name: str, rows: list[dict], keys: list[str] | None = None) -> None:
    """Print a CSV block and persist it under artifacts/bench/."""
    if not rows:
        print(f"# {name}: no rows")
        return
    keys = keys or list(rows[0].keys())
    lines = [",".join(keys)]
    for r in rows:
        lines.append(",".join(_fmt(r.get(k)) for k in keys))
    text = "\n".join(lines)
    print(f"# --- {name} ---")
    print(text)
    os.makedirs(os.path.join(ART, "bench"), exist_ok=True)
    with open(os.path.join(ART, "bench", f"{name}.csv"), "w") as f:
        f.write(text + "\n")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


@functools.lru_cache(maxsize=8)
def graph_and_params(model: str, batch: int = 1):
    """The port's graph of one of the paper's CNNs and its numpy params
    (``LayerGraph.init`` at seed 0)."""
    from repro_torch.models import cnn
    g = cnn.BUILDERS[model](batch=batch)
    return g, g.init(0)
