"""Primitive layers: linear / norm / embedding / RoPE / MLP (the twin of
``repro.models.layers``).

Params are plain nested dicts.  ``init_*`` functions take an explicit numpy
``Generator`` and return numpy arrays in the reference's names and
layouts (the port's params travel as numpy, like the JAX package's weight
blobs, and become device tensors in :meth:`LayerGraph.prepare`); the
apply functions take torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def he_init(rng: np.random.Generator, shape, dtype, fan_in=None) -> np.ndarray:
    fan_in = fan_in or shape[0]
    return (rng.standard_normal(shape, np.float32)
            * np.float32(np.sqrt(2.0 / fan_in))).astype(dtype)


# -- linear -----------------------------------------------------------------

def init_linear(rng: np.random.Generator, d_in: int, d_out: int, dtype) -> dict:
    return {"w": he_init(rng, (d_in, d_out), dtype)}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


# -- norms --------------------------------------------------------------------

def init_rmsnorm(d: int, dtype) -> dict:
    return {"scale": np.ones((d,), dtype)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalised in float32 whatever x's dtype, then cast back."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(dt)


# -- embedding ----------------------------------------------------------------

def init_embedding(rng: np.random.Generator, vocab: int, d: int, dtype) -> dict:
    return {"table": (rng.standard_normal((vocab, d), np.float32)
                      * np.float32(0.02)).astype(dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T


# -- RoPE ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  The two
    halves of hd are rotated as pairs (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs      # [..., S, hd/2]
    angles = angles[..., None, :]                                # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP -------------------------------------------------------------------------

def init_mlp(rng: np.random.Generator, d: int, f: int, gated: bool,
             dtype) -> dict:
    p = {"ln": init_rmsnorm(d, dtype),
         "up": init_linear(rng, d, f, dtype),
         "down": init_linear(rng, f, d, dtype)}
    if gated:
        p["gate"] = init_linear(rng, d, f, dtype)
    return p


def mlp(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Pre-norm residual MLP: SiLU-gated when ``p`` has a gate, else
    GELU in its tanh form (``jax.nn.gelu``'s default)."""
    h = rmsnorm(p["ln"], x, eps)
    up = linear(p["up"], h)
    if "gate" in p:
        up = F.silu(linear(p["gate"], h)) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return x + linear(p["down"], up)


def mlp_flops(d: int, f: int, gated: bool, tokens: int) -> float:
    mats = 3 if gated else 2
    return 2.0 * mats * d * f * tokens
