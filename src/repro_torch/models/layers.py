"""Primitive layers: linear / norm / embedding / RoPE / MLP (the twin of
``repro.models.layers``).

Params are plain nested dicts.  ``init_*`` functions take an explicit numpy
``Generator`` and return numpy arrays in the reference's names and
layouts (the port's params travel as numpy, like the JAX package's weight
blobs, and become device tensors in :meth:`LayerGraph.prepare`); the
apply functions take torch tensors.
"""
from __future__ import annotations

import dataclasses
import math

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

@dataclasses.dataclass(frozen=True)
class Yarn:
    """YaRN's rescaling of RoPE (a config's ``rope_type: yarn`` section):
    frequencies of fewer than ``beta_slow`` turns over the original
    context are divided by ``factor``, those of more than ``beta_fast``
    kept, a linear ramp between; cos and sin are scaled by
    ``attention_factor``."""

    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 1.0


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu",
               yarn: Yarn | None = None) -> torch.Tensor:
    base = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                  device=device) / head_dim)
    if yarn is None:
        return 1.0 / base
    # Hugging Face transformers' _compute_yarn_parameters (truncate=True)
    def turns_dim(turns: float) -> float:
        return (head_dim * math.log(yarn.original_max_position_embeddings
                                    / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    lo = max(math.floor(turns_dim(yarn.beta_fast)), 0)
    hi = min(math.ceil(turns_dim(yarn.beta_slow)), head_dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - lo) / (hi - lo)).clamp(0, 1)
    keep = 1 - ramp
    return 1.0 / (yarn.factor * base) * (1 - keep) + 1.0 / base * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, yarn: Yarn | None = None) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  The two
    halves of hd are rotated as pairs (not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device, yarn)                # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs      # [..., S, hd/2]
    angles = angles[..., None, :]                                # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if yarn is not None:
        cos, sin = cos * yarn.attention_factor, sin * yarn.attention_factor
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
