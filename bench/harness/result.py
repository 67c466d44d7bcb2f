"""The result of one run: the compared numbers, and the lines printed."""
from __future__ import annotations

import dataclasses
import json
import math
import sys

# a compared number that is not finite prints as this, with ok false
NOT_FINITE = 1e300


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``ok`` when value <= limit."""
    name: str
    value: float
    limit: float

    def __post_init__(self):
        if not math.isfinite(self.value):
            self.value = NOT_FINITE

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def emit_checks(checks: list[Check], err=sys.stderr) -> None:
    """Each compared number beside its limit, as the last lines on
    standard error."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=err)
    err.flush()


def line(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: list[Check], breakdown: dict | None) -> str:
    """The result's JSON line; the compared numbers come last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return json.dumps(out)
