"""Public wrappers around the port's kernels (twin of ``repro.kernels.ops``).

Padding and reshaping to tile multiples live here so the kernels stay
shape-exact; each call runs the CUDA kernel for a CUDA tensor and the
plain PyTorch version for a CPU tensor (see
:mod:`repro_torch.kernels.block_quant`,
:mod:`repro_torch.kernels.decode_attention` and
:mod:`repro_torch.kernels.ssd_scan`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import block_quant as _bq
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ssd_scan as _ssd


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


# -- decode attention ------------------------------------------------------------

def decode_attention(q, k, v, kpos, pos, window, scale):
    """q [B,1,H,hd]; k/v [B,C,kv,hd]; kpos [B,C]; pos [B] -> [B,1,H,hd].

    For the kernel (a CUDA cache), pads C to its block with zero K/V and
    ``kpos = -1`` and names the C slots that are the cache, so the padding
    gets no weight even in an all-empty row; the plain version (a CPU
    cache) takes the cache as it is."""
    C = k.shape[1]
    pad = (-C) % _da.BLOCK_C
    if pad and q.device.type != "cpu":
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-1)
    return _da.decode_attention(q, k, v, kpos, pos, window, scale, live=C)


# -- SSD scan ----------------------------------------------------------------------

def ssd_scan(xc, dtc, A, Bc, Cc, init_state):
    """Chunked inputs -> (y [B, nc*Q, H, P], final_state [B,H,P,N]).

    Matches the return convention of ``ssm.ssd_chunked``'s scan path:
    callers trim padding rows themselves (they know S_orig).  ``A`` and
    the state go to the kernel as float32, as the reference's wrapper
    casts them, and every input contiguous (the model hands over slices
    of one projection)."""
    B, nc, Q, H, P = xc.shape
    y, fin = _ssd.ssd_scan(
        xc.contiguous(), dtc.contiguous(), A.to(torch.float32).contiguous(),
        Bc.contiguous(), Cc.contiguous(),
        init_state.to(torch.float32).contiguous())
    return y.reshape(B, nc * Q, H, P), fin
