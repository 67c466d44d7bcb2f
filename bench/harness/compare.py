"""The comparison that decides ``correct`` for served logits.

A row of served logits is held to the reference's row of the same input:
the number compared is ``max(|served - reference| - step / 2) /
max |reference|`` over the row, and the largest over the rows, where
``step`` is the quantization step of the wire's last hop at that value
(0 where the wire is raw).  So what the wire's own rounding explains is not
counted, and only what the computation adds is.

The last hop quantizes a wave's rows stacked: tiles of 1,024 consecutive
values that may straddle two requests, whose scale (absmax / 127) the
request does not see alone.  :func:`tile_steps` reads each value's step
from the served row itself: the row began at one of a few offsets within
a tile (``classes * p mod 1024`` for its place p in the wave), and each
piece of the row between tile edges holds whole multiples, at most 127 in
size, of one step.  The step of a piece is the largest such step; a row
that fits no offset reads a step that is not a number, and an infinite
error.
"""
from __future__ import annotations

import math

import torch

TILE = 1024
LEVELS = 127
TOL = 1e-3              # |value / step - nearest whole number| allowed
CHUNK = 256             # rows at a time: CHUNK x 127 x row length floats


def wave_offsets(classes: int, max_batch: int) -> list[int]:
    """Where within a tile a row of ``classes`` values can begin, for each
    place in a wave of up to ``max_batch`` rows."""
    return sorted({classes * p % TILE for p in range(max_batch)})


def _pieces(n: int, offset: int) -> list[tuple[int, int]]:
    edges = [0] + list(range((TILE - offset) % TILE or TILE, n, TILE)) + [n]
    return [(a, b) for a, b in zip(edges, edges[1:]) if b > a]


def _piece_steps(v: torch.Tensor) -> torch.Tensor:
    """The largest step of which every value of each row of ``v`` [N, L] is
    a whole multiple of at most LEVELS, or nan."""
    m = v.abs().amax(dim=1)
    q = torch.arange(1, LEVELS + 1, dtype=v.dtype, device=v.device)
    out = torch.full_like(m, math.nan)
    for lo in range(0, v.shape[0], CHUNK):
        s = m[lo:lo + CHUNK, None] / q[None, :]                # [n, Q]
        r = v[lo:lo + CHUNK, None, :] / s[:, :, None]          # [n, Q, L]
        fits = ((r - r.round()).abs().amax(dim=2) <= TOL) \
            & (m[lo:lo + CHUNK, None] > 0)
        first = fits.to(torch.int8).argmax(dim=1)
        got = s.gather(1, first[:, None])[:, 0]
        out[lo:lo + CHUNK] = torch.where(fits.any(dim=1), got,
                                         torch.full_like(got, math.nan))
    return out


def tile_steps(y: torch.Tensor, offsets: list[int]) -> torch.Tensor:
    """The step of every value of the served rows ``y`` [N, n] (f32), read
    at the first of ``offsets`` at which each piece of the row fits."""
    steps = torch.full_like(y, math.nan)
    todo = torch.ones(y.shape[0], dtype=torch.bool, device=y.device)
    for off in offsets:
        cand = torch.empty_like(y)
        ok = todo.clone()
        for a, b in _pieces(y.shape[1], off):
            s = _piece_steps(y[:, a:b])
            cand[:, a:b] = s[:, None]
            ok &= ~s.isnan()
        steps[ok] = cand[ok]
        todo &= ~ok
    return steps


def logits_err(y: torch.Tensor, z: torch.Tensor,
               steps: torch.Tensor | None) -> float:
    """The number compared: the largest over rows of the served rows ``y``
    [N, n] of ``max(|y - z| - steps / 2) / max |z|``; ``steps`` None for a
    raw wire.  Not a number anywhere reads infinite."""
    if y.shape != z.shape:
        return math.inf
    gap = (y - z).abs()
    if steps is not None:
        gap = (gap - steps / 2).clamp(min=0.0)
    err = gap.amax(dim=1) / z.abs().amax(dim=1)
    worst = float(err.max()) if err.numel() else 0.0
    return worst if math.isfinite(worst) else math.inf
