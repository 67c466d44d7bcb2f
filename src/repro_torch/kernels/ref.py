"""Plain PyTorch versions of the port's kernels (twin of
``repro.kernels.ref``).

Each function is the numerical ground truth its kernel is held against:
the wrappers in :mod:`repro_torch.kernels.block_quant`,
:mod:`repro_torch.kernels.decode_attention` and
:mod:`repro_torch.kernels.ssd_scan` run it for a CPU tensor, the CPU
tests hold it against the JAX oracle (byte for byte for block
quantization, to a stated tolerance for attention and the SSD scan), and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  They
are deliberately written in the most obvious way.
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

# The reference's platforms have no subnormal floats: XLA treats a subnormal
# input as zero (DAZ) and flushes a subnormal result to zero (FTZ), and a TPU
# has none at all.  The plain versions (and the CUDA kernel) flush
# explicitly, keeping the sign, so q8 blobs stay byte-identical on tiles
# whose absmax is subnormal or just above FLT_MIN.  Not
# ``torch.set_flush_denormal``: that is a setting of the whole process.
FLT_MIN = float(np.finfo(np.float32).tiny)


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """|x| < FLT_MIN -> a zero of x's sign; NaN and everything else kept."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


# -- block quantization (the ZFP fixed-rate adaptation) -----------------------

def quantize_blocks_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-rate shared-scale int8 quantization per (8,128) tile.

    x [R, C] (R % 8 == 0, C % 128 == 0) -> (q int8 [R, C],
    scales f32 [R/8, C/128]).  scale = absmax * INV127 per tile (1.0 for
    an all-zero tile); q = clip(round_half_even(x/scale), ±127) with an
    IEEE division.  Subnormal inputs and scales flush to zero first (see
    ``FLT_MIN``); a NaN quotient (0/0 over a flushed scale, or a NaN
    input) gives q = 0, as XLA's and the CUDA kernel's casts do.
    """
    R, C = x.shape
    tr, tc = R // TILE_R, C // TILE_C
    xt = flush_subnormal(x.to(torch.float32).reshape(tr, TILE_R, tc, TILE_C))
    absmax = xt.abs().amax(dim=(1, 3))                          # [tr, tc]
    scale = flush_subnormal(torch.where(absmax > 0, absmax * INV127,
                                        torch.ones_like(absmax)))
    r = torch.round(xt / scale[:, None, :, None])
    q = torch.clamp(torch.where(r.isnan(), 0.0, r), -127, 127)
    return q.to(torch.int8).reshape(R, C), scale


def dequantize_blocks_ref(q: torch.Tensor, scale: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    R, C = q.shape
    tr, tc = R // TILE_R, C // TILE_C
    qt = q.to(torch.float32).reshape(tr, TILE_R, tc, TILE_C)
    s = flush_subnormal(scale.to(torch.float32))
    out = flush_subnormal(qt * s[:, None, :, None])
    return out.reshape(R, C).to(dtype)


# -- the q8 wire's ragged form: the first n values of a zero-padded grid ------

def wire_layout(n: int, ntiles: int) -> tuple[int, int]:
    """(byte offset of the scales, total bytes) of the packed q8 wire
    buffer: n int8 values, then the ntiles float32 scales from the next
    16-byte boundary."""
    off = -(-n // 16) * 16
    return off, off + 4 * ntiles


def quantize_ragged_ref(x: torch.Tensor, ntiles: int) -> torch.Tensor:
    """x f32 [n]: the first n values of a [8·ntiles, 128] grid whose rest
    is zero -> the packed buffer uint8 [wire_layout(n, ntiles)[1]]: q of
    the n values, then the scales of all ntiles tiles (1.0 for a tile of
    padding only); the bytes between are zero."""
    n = x.numel()
    grid = torch.zeros(ntiles * TILE_R * TILE_C, dtype=torch.float32,
                       device=x.device)
    grid[:n] = x.reshape(-1)
    q, s = quantize_blocks_ref(grid.reshape(-1, TILE_C))
    off, nbytes = wire_layout(n, ntiles)
    out = torch.zeros(nbytes, dtype=torch.uint8, device=x.device)
    out[:n] = q.reshape(-1)[:n].view(torch.uint8)
    out[off:] = s.reshape(-1).view(torch.uint8)
    return out


def dequantize_ragged_ref(q: torch.Tensor, scales: torch.Tensor
                          ) -> torch.Tensor:
    """q int8 [n] (the first n values of a [8·ntiles, 128] grid whose
    rest is zero) and scales f32 [ntiles] -> float32 [n]."""
    n = q.numel()
    grid = torch.zeros(scales.numel() * TILE_R * TILE_C, dtype=torch.int8,
                       device=q.device)
    grid[:n] = q.reshape(-1)
    out = dequantize_blocks_ref(grid.reshape(-1, TILE_C),
                                scales.reshape(-1, 1))
    return out.reshape(-1)[:n]


# -- single-token decode attention ---------------------------------------------

NEG_INF = -1e30


def decode_attention_ref(q, k, v, kpos, pos, window, scale):
    """q [B,1,H,hd]; k/v [B,C,kv,hd]; kpos [B,C] absolute position per cache
    slot (-1 = empty); pos [B] current position.  GQA broadcast; returns
    [B,1,H,hd] in f32.  Invalid slots are masked with -1e30, so an
    all-empty cache gives uniform weights (finite) rather than NaN."""
    B, _, H, hd = q.shape
    C, kv = k.shape[1], k.shape[2]
    g = H // kv
    qg = q.to(torch.float32).reshape(B, kv, g, hd)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    logits = torch.einsum("bkgh,bskh->bkgs", qg, kf) * scale     # [B,kv,g,C]
    delta = pos[:, None] - kpos                                  # [B,C]
    valid = (kpos >= 0) & (delta >= 0)
    if window is not None:
        valid &= delta < window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", w, vf)
    return out.reshape(B, 1, H, hd)


# -- SSD (Mamba2) chunked scan ---------------------------------------------------

def ssd_scan_ref(xc, dtc, A, Bc, Cc, init_state):
    """Chunked state-space-dual scan (arXiv:2405.21060), plain PyTorch.

    xc [B,nc,Q,H,P]; dtc [B,nc,Q,H] (>0); A [H] (<0); Bc/Cc [B,nc,Q,N]
    (single B/C group broadcast over heads); init_state [B,H,P,N].
    Returns (y [B,nc,Q,H,P] in xc.dtype, final_state [B,H,P,N] f32).
    A Python loop over chunks, f32 throughout.  The causal mask is applied
    BEFORE the exp: above the diagonal ``cum_i - cum_j`` is a positive sum
    of ``dt*|A|``, whose exp overflows to inf once a chunk's sum passes ~88
    (and inf * 0 is NaN).
    """
    Q = xc.shape[2]
    f32 = torch.float32
    A = A.to(f32)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xc.device))
    state = init_state.to(f32)
    ys = []
    for c in range(xc.shape[1]):
        xq = xc[:, c].to(f32)                                # [B,Q,H,P]
        dtq = dtc[:, c].to(f32)                              # [B,Q,H]
        Bq, Cq = Bc[:, c].to(f32), Cc[:, c].to(f32)          # [B,Q,N]
        cum = torch.cumsum(dtq * A, dim=1)                   # [B,Q,H]
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # [B,Q,Q,H]
        Lmat = torch.exp(torch.where(causal[None, :, :, None], diff,
                                     -torch.inf))
        CB = torch.einsum("bqn,bsn->bqs", Cq, Bq)
        scores = CB[:, :, :, None] * Lmat * dtq[:, None, :, :]
        y = torch.einsum("bqsh,bshp->bqhp", scores, xq)
        y = y + torch.einsum("bqn,bhpn->bqhp", Cq, state) \
            * torch.exp(cum)[:, :, :, None]
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)
        dx = xq * (dtq * decay_to_end)[..., None]
        state = state * torch.exp(cum[:, -1])[:, :, None, None] \
            + torch.einsum("bqhp,bqn->bhpn", dx, Bq)
        ys.append(y.to(xc.dtype))
    return torch.stack(ys, dim=1), state
