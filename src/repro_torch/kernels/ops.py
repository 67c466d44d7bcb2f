"""Public wrappers around the port's kernels (twin of ``repro.kernels.ops``,
block-quantization part).

Padding and reshaping to tile multiples live here so the kernel stays
shape-exact; each call runs the CUDA kernel for a CUDA tensor and the
plain PyTorch version for a CPU tensor (see
:mod:`repro_torch.kernels.block_quant`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import block_quant as _bq


# -- block quantization (wire compression for the DEFER pipeline) ---------------

def quantize_blocks(x: torch.Tensor):
    """Any-rank x -> (q int8 [R,C], scales, meta) with padding to (8,128)."""
    shape = tuple(x.shape)
    flat = x.reshape(-1, shape[-1]) if x.dim() > 1 else x.reshape(1, -1)
    R, C = flat.shape
    padr, padc = (-R) % _bq.TILE_R, (-C) % _bq.TILE_C
    if padr or padc:
        flat = F.pad(flat, (0, padc, 0, padr))
    q, s = _bq.quantize_blocks(flat.contiguous())
    return q, s, (shape, R, C)


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor, meta,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    shape, R, C = meta
    x = _bq.dequantize_blocks(q, scales)
    return x[:R, :C].reshape(shape).to(dtype)


def quant_bytes(shape, dtype=torch.bfloat16) -> tuple[int, int]:
    """(raw_bytes, wire_bytes) for a tensor sent through the quant codec."""
    n = int(np.prod(shape))
    itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    raw = n * itemsize
    wire = n * 1 + (n // (_bq.TILE_R * _bq.TILE_C)) * 4   # int8 + f32 scales
    return raw, wire
