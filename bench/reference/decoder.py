"""A decoder-only transformer in plain PyTorch: the benchmark's plain
reference for the ``starcoder2-3b-chain`` configuration.

It imports nothing of the program.  The equations, per layer: RMSNorm
``x * rsqrt(mean(x^2) + 1e-5) * scale``; grouped-query attention whose
query, key and value projections have no bias, rotary positions on q and
k (theta 1e4, the two halves of a head rotated as pairs), causal softmax
at ``1/sqrt(head_dim)``, an output projection added to the residual; then
RMSNorm, an ungated tanh-GELU MLP added to the residual.  After the last
layer, RMSNorm and an untied output projection give the logits.

Weights are the benchmark's own tree: ``embed.table`` [vocab, d];
``blk{i}_attn``: ``ln.scale``, ``wq.w``, ``wk.w``, ``wv.w``, ``wo.w``
(each [in, out]); ``blk{i}_mlp``: ``ln.scale``, ``up.w``, ``down.w``;
``head``: ``ln.scale``, ``out.w``.  ``tf32`` rounds every matrix
product's operands to TF32 first: the control's lower precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.resnet50 import _tf32


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] at positions 0 .. S-1."""
    S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def forward(params: dict, tokens: torch.Tensor, heads: int, kv_heads: int,
            head_dim: int, rope_theta: float = 1e4,
            tf32: bool = False) -> torch.Tensor:
    """Logits [S, vocab] of one sequence ``tokens`` [S] (int64), f32:
    row t is the prediction of token t + 1."""
    mm = ((lambda a, b: _tf32(a) @ _tf32(b)) if tf32
          else (lambda a, b: a @ b))
    x = params["embed"]["table"][tokens]
    S = x.shape[0]
    g = heads // kv_heads
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    i = 0
    while f"blk{i}_attn" in params:
        p = params[f"blk{i}_attn"]
        h = _rms(x, p["ln"]["scale"])
        q = _rope(mm(h, p["wq"]["w"]).reshape(S, heads, head_dim), rope_theta)
        k = _rope(mm(h, p["wk"]["w"]).reshape(S, kv_heads, head_dim),
                  rope_theta)
        v = mm(h, p["wv"]["w"]).reshape(S, kv_heads, head_dim)
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        att = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(head_dim)
        att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
        o = mm(att, v.transpose(0, 1)).transpose(0, 1).reshape(S, -1)
        x = x + mm(o, p["wo"]["w"])
        p = params[f"blk{i}_mlp"]
        h = _rms(x, p["ln"]["scale"])
        x = x + mm(F.gelu(mm(h, p["up"]["w"]), approximate="tanh"),
                   p["down"]["w"])
        i += 1
    p = params["head"]
    return mm(_rms(x, p["ln"]["scale"]), p["out"]["w"])
