"""Attention: GQA with RoPE, chunked (memory-bounded) causal attention,
banded sliding-window attention, cross-attention, and cached decode (the
twin of ``repro.models.attention``).

Shapes: x [B, S, d]; K/V heads ``kv``; query heads ``H = g * kv``.
Caches: K,V as [B, C, kv, hd] where C = full seq for global layers or the
window size (ring buffer) for sliding-window layers.

Full-sequence attention is plain PyTorch, as the reference computes it
outside any Pallas kernel; one decode step's attention over the cache
runs the port's CUDA kernel when ``use_kernel`` is set.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import current_step_rows
from repro_torch.device import get_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import INV127
from repro_torch.models.layers import (Yarn, apply_rope, init_linear,
                                       init_rmsnorm, linear, rmsnorm)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    window: int | None = None        # sliding window (tokens), None = global
    causal: bool = True
    q_chunk: int = 1024              # chunking for memory-bounded attention
    yarn: Yarn | None = None         # YaRN's rescaling of RoPE, None = plain


def init_attn(rng: np.random.Generator, s: AttnSpec, dtype) -> dict:
    return {
        "ln": init_rmsnorm(s.d_model, dtype),
        "wq": init_linear(rng, s.d_model, s.num_heads * s.head_dim, dtype),
        "wk": init_linear(rng, s.d_model, s.kv_heads * s.head_dim, dtype),
        "wv": init_linear(rng, s.d_model, s.kv_heads * s.head_dim, dtype),
        "wo": init_linear(rng, s.num_heads * s.head_dim, s.d_model, dtype),
    }


def _project_qkv(p, s: AttnSpec, x, positions):
    B, S, _ = x.shape
    q = linear(p["wq"], x).reshape(B, S, s.num_heads, s.head_dim)
    k = linear(p["wk"], x).reshape(B, S, s.kv_heads, s.head_dim)
    v = linear(p["wv"], x).reshape(B, S, s.kv_heads, s.head_dim)
    q = apply_rope(q, positions, s.rope_theta, s.yarn)
    k = apply_rope(k, positions, s.rope_theta, s.yarn)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q [B,Cq,H,hd], k/v [B,Ck,kv,hd] (GQA broadcast), mask [B?,Cq,Ck]."""
    B, Cq, H, hd = q.shape
    kv = k.shape[2]
    g = H // kv
    qg = q.reshape(B, Cq, kv, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32) * scale
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Cq, H, hd)


def attention(p: dict, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
              eps: float = 1e-5, kv_override=None) -> torch.Tensor:
    """Full-sequence attention (train / prefill), memory-bounded.

    Loops over query chunks so live logits are [B,H,Cq,S] not [B,H,S,S];
    sliding-window layers use a banded gather so their FLOPs and memory
    scale with S * window, not S^2.  (``kv_override`` is accepted, and
    ignored, as in the reference.)
    """
    return attention_kv(p, s, x, positions, eps)[0]


def attention_kv(p: dict, s: AttnSpec, x: torch.Tensor,
                 positions: torch.Tensor, eps: float = 1e-5):
    """:func:`attention`'s output with the keys (after RoPE) and values
    it attended over: (y, k [B,S,kv,hd], v [B,S,kv,hd])."""
    B, S, _ = x.shape
    h = rmsnorm(p["ln"], x, eps)
    q, k, v = _project_qkv(p, s, h, positions)
    scale = 1.0 / np.sqrt(s.head_dim)

    C = min(s.q_chunk, S)                 # the last chunk may be shorter
    if positions.dim() == 1:
        positions = positions[None].expand(B, S)

    if s.window is not None and s.window < S:
        out = _banded_attention(q, k, v, positions, positions, s, scale, C)
    else:
        out = _chunked_attention(q, k, v, positions, positions, s, scale, C)
    out = out.reshape(B, S, s.num_heads * s.head_dim)
    return x + linear(p["wo"], out), k, v


def _chunked_attention(q, k, v, pos_q, pos_k, s, scale, C):
    """Loop over query chunks of C rows (the last may hold fewer); each
    sees the full K (causal-masked).  q [B,S,H,hd], pos_q / pos_k [B,S]
    -> [B,S,H,hd]."""
    B, S = q.shape[:2]
    outs = []
    for a in range(0, S, C):
        qc, pq = q[:, a:a + C], pos_q[:, a:a + C]   # [B,c,H,hd], [B,c]
        if s.causal:
            mask = pq[:, :, None] >= pos_k[:, None, :]
        else:
            mask = torch.ones((B, qc.shape[1], pos_k.shape[1]),
                              dtype=torch.bool, device=qc.device)
        outs.append(_sdpa(qc, k, v, mask, scale))
    return torch.cat(outs, dim=1)


def _banded_attention(q, k, v, pos_q, pos_k, s, scale, C):
    """Sliding window: q chunk i attends only to k chunks [i-nb+1 .. i]
    (chunks of C positions, the last may hold fewer; a chunk before the
    first is chunk 0 again, masked out).

    nb = ceil(window/C) + 1 chunks; FLOPs ~ S * (nb*C) instead of S^2.
    """
    B, S = q.shape[:2]
    nb = int(np.ceil(s.window / C)) + 1
    dev = q.device
    step = torch.arange(C, device=dev)
    outs = []
    for i, a in enumerate(range(0, S, C)):
        qc, pq = q[:, a:a + C], pos_q[:, a:a + C]
        band = torch.arange(i - nb + 1, i + 1, device=dev)
        m = (nb - 1) * C + qc.shape[1]        # chunk i itself ends at S
        slots = (band.clamp(min=0)[:, None] * C + step).reshape(-1)[:m]
        bvalid = (band >= 0).repeat_interleave(C)[:m]
        kb, vb, pb = k[:, slots], v[:, slots], pos_k[:, slots]
        delta = pq[:, :, None] - pb[:, None, :]
        mask = (delta >= 0) & (delta < s.window)
        mask &= bvalid[None, None, :]
        outs.append(_sdpa(qc, kb, vb, mask, scale))
    return torch.cat(outs, dim=1)


# -- cross attention (enc-dec) --------------------------------------------------

def init_cross_attn(rng: np.random.Generator, s: AttnSpec, dtype) -> dict:
    return init_attn(rng, s, dtype)


def cross_attention(p: dict, s: AttnSpec, x: torch.Tensor, enc: torch.Tensor,
                    enc_mask: torch.Tensor | None = None, eps: float = 1e-5):
    B, S, _ = x.shape
    Se = enc.shape[1]
    h = rmsnorm(p["ln"], x, eps)
    q = linear(p["wq"], h).reshape(B, S, s.num_heads, s.head_dim)
    k = linear(p["wk"], enc).reshape(B, Se, s.kv_heads, s.head_dim)
    v = linear(p["wv"], enc).reshape(B, Se, s.kv_heads, s.head_dim)
    mask = torch.ones((B, S, Se), dtype=torch.bool, device=x.device) \
        if enc_mask is None else enc_mask[:, None, :].expand(B, S, Se)
    out = _sdpa(q, k, v, mask, 1.0 / np.sqrt(s.head_dim))
    return x + linear(p["wo"], out.reshape(B, S, -1))


# -- cached decode ----------------------------------------------------------------

def init_cache(s: AttnSpec, batch: int, max_len: int, dtype: torch.dtype,
               quant: bool = False,
               device: str | torch.device | None = None) -> dict:
    """KV cache on ``device`` (CUDA unless the caller asks for the CPU).
    ``quant=True`` stores int8 values with one f32 scale per (position,
    kv head) row: half the cache's residency and reads per decoded token.
    """
    dev = get_device(device)
    C = min(max_len, s.window) if s.window else max_len
    shape = (batch, C, s.kv_heads, s.head_dim)
    if quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "kscale": torch.zeros(shape[:3], dtype=torch.float32, device=dev),
            "vscale": torch.zeros(shape[:3], dtype=torch.float32, device=dev),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., hd] -> (int8 [..., hd], scale [...]) with per-row absmax.

    The reference writes ``absmax / 127.0``; its jitted decode step (where
    the int8 cache is written) multiplies by the float32 reciprocal, and
    so does the port (``INV127``), which keeps the cache bytes equal."""
    x32 = x.to(torch.float32)
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax * INV127, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequant_rows(q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def decode_attention_ref(q, cache_k, cache_v, kpos, pos, window, scale):
    """Single-token attention over a cache. q [B,1,H,hd]; cache [B,C,kv,hd];
    kpos [B,C] absolute positions stored in each cache slot (-1 = empty)."""
    delta = pos[:, None] - kpos                         # [B,C]
    valid = (kpos >= 0) & (delta >= 0)
    if window is not None:
        valid &= delta < window
    return _sdpa(q, cache_k, cache_v, valid[:, None, :], scale)


def attention_decode(p: dict, s: AttnSpec, x: torch.Tensor, pos: torch.Tensor,
                     cache: dict, kpos: torch.Tensor, eps: float = 1e-5,
                     use_kernel: bool = False):
    """One decode step.  x [B,1,d]; pos [B] int32 absolute position;
    kpos [B,C] int32.

    Returns (out, new_cache, new_kpos).  Sliding-window caches are ring
    buffers indexed by pos % window.  Where the reference returns updated
    copies, the port writes the new slot into ``cache``'s tensors and
    ``kpos`` in place and returns them: a copy of the whole cache per layer
    and step would double the step's memory traffic.  Inside a replica's
    step (:func:`~repro_torch.core.graph.current_step_rows`) only the live
    rows write: the others' caches keep their values bit for bit.
    """
    B = x.shape[0]
    h = rmsnorm(p["ln"], x, eps)
    q = linear(p["wq"], h).reshape(B, 1, s.num_heads, s.head_dim)
    k = linear(p["wk"], h).reshape(B, 1, s.kv_heads, s.head_dim)
    v = linear(p["wv"], h).reshape(B, 1, s.kv_heads, s.head_dim)
    q = apply_rope(q, pos[:, None], s.rope_theta, s.yarn)
    k = apply_rope(k, pos[:, None], s.rope_theta, s.yarn)

    C = cache["k"].shape[1]
    slot = (pos % C).long()                            # ring for window layers
    bidx = torch.arange(B, device=x.device)
    # inside a replica's step the rows it does not serve are other sessions'
    # slots of its cache pool, or empty ones: they keep what they hold
    rows = current_step_rows()
    keep = None if rows is None else rows.live == 0

    def write(buf: torch.Tensor, new: torch.Tensor) -> None:
        if keep is not None:
            new = torch.where(keep.view((B,) + (1,) * (new.dim() - 1)),
                              buf[bidx, slot], new)
        buf[bidx, slot] = new

    write(kpos, pos.to(kpos.dtype))
    if cache["k"].dtype == torch.int8:
        kq, ks = quant_rows(k[:, 0])
        vq, vs = quant_rows(v[:, 0])
        write(cache["k"], kq)
        write(cache["v"], vq)
        write(cache["kscale"], ks)
        write(cache["vscale"], vs)
        ck_f = dequant_rows(cache["k"], cache["kscale"], x.dtype)
        cv_f = dequant_rows(cache["v"], cache["vscale"], x.dtype)
    else:
        write(cache["k"], k[:, 0].to(cache["k"].dtype))
        write(cache["v"], v[:, 0].to(cache["v"].dtype))
        ck_f, cv_f = cache["k"], cache["v"]

    scale = 1.0 / np.sqrt(s.head_dim)
    if use_kernel:
        out = kops.decode_attention(q, ck_f, cv_f, kpos, pos, s.window, scale)
    else:
        out = decode_attention_ref(q, ck_f, cv_f, kpos, pos, s.window, scale)
    out = x + linear(p["wo"], out.reshape(B, 1, -1))
    return out, cache, kpos


def attn_flops(s: AttnSpec, tokens: int, kv_len: int) -> float:
    proj = 2.0 * tokens * s.d_model * (s.num_heads + 2 * s.kv_heads + s.num_heads) \
        * s.head_dim
    eff_kv = min(kv_len, s.window) if s.window else kv_len
    attn = 4.0 * tokens * eff_kv * s.num_heads * s.head_dim
    return proj + attn
