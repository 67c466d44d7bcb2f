"""Block quantization of a wire leaf, in plain PyTorch.

The q8 wire flattens each leaf in C order and cuts it into tiles of 1,024
consecutive values (one (8, 128) tile of a 128-wide grid).  Each tile gets
one scale, ``absmax * f32(1/127)`` (1.0 for an all-zero tile), and each value
``clip(round_half_even(x / scale), -127, 127)``; the receiver multiplies back.
Values whose magnitude is below FLT_MIN count as zero, sign kept.

A leaf of a request is quantized on its own.
"""
from __future__ import annotations

import numpy as np
import torch

TILE = 1024
LEVELS = 127
FLT_MIN = float(np.finfo(np.float32).tiny)


def _flush(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    """``x`` f32 of any shape through quantize and dequantize, per tile of
    its own C-order values; the result has ``x``'s shape."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    pad = -n % TILE
    grid = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, TILE)
    grid = _flush(grid)
    absmax = grid.abs().amax(dim=1, keepdim=True)
    inv = float(np.float32(1.0) / np.float32(LEVELS))
    scale = _flush(torch.where(absmax > 0, absmax * inv,
                               torch.ones_like(absmax)))
    r = torch.round(grid / scale)
    # + 0.0 makes a zero positive, as an integer q has no negative zero
    q = torch.clamp(torch.where(r.isnan(), 0.0, r), -LEVELS, LEVELS) + 0.0
    out = _flush(q * scale).reshape(-1)[:n]
    return out.reshape(x.shape)
