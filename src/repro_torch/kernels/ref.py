"""Plain PyTorch versions of the port's kernels (twin of
``repro.kernels.ref``).

Each function is the numerical ground truth its kernel is held against:
the wrappers in :mod:`repro_torch.kernels.block_quant` run it for a CPU
tensor, the CPU tests hold it byte for byte against the JAX oracle, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  They are
deliberately written in the most obvious way.
"""
from __future__ import annotations

import numpy as np
import torch

TILE_R, TILE_C = 8, 128  # the wire format's tile: 8 rows x 128 columns

# 1/127 rounded to float32.  The reference writes ``absmax / 127.0``, but
# compiled (jit, and the Pallas kernel behind the q8 wire) XLA rewrites a
# division by a constant into a multiply by its float32 reciprocal, so the
# scales it ships are ``absmax * f32(1/127)``.  The port computes that,
# which keeps Q8 blobs byte-identical.  (Run op by op, the JAX oracle
# divides instead and its scale can differ in the last bit.)
INV127 = float(np.float32(1.0) / np.float32(127.0))


# -- block quantization (the ZFP fixed-rate adaptation) -----------------------

def quantize_blocks_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-rate shared-scale int8 quantization per (8,128) tile.

    x [R, C] (R % 8 == 0, C % 128 == 0) -> (q int8 [R, C],
    scales f32 [R/8, C/128]).  scale = absmax * INV127 per tile (1.0 for
    an all-zero tile); q = clip(round_half_even(x/scale), ±127) with an
    IEEE division.
    """
    R, C = x.shape
    tr, tc = R // TILE_R, C // TILE_C
    xt = x.to(torch.float32).reshape(tr, TILE_R, tc, TILE_C)
    absmax = xt.abs().amax(dim=(1, 3))                          # [tr, tc]
    scale = torch.where(absmax > 0, absmax * INV127,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xt / scale[:, None, :, None]), -127, 127)
    return q.to(torch.int8).reshape(R, C), scale


def dequantize_blocks_ref(q: torch.Tensor, scale: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    R, C = q.shape
    tr, tc = R // TILE_R, C // TILE_C
    qt = q.to(torch.float32).reshape(tr, TILE_R, tc, TILE_C)
    return (qt * scale[:, None, :, None]).reshape(R, C).to(dtype)
