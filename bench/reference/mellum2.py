"""Mellum2-12B-A2.5B in plain PyTorch: the benchmark's plain reference for
the ``mellum2-12b-chain`` configuration, held share of the experts
included.

It imports nothing of the program, sets ``allow_tf32`` False, and has no
cache, no kernels and no batching: one sequence's full causal forward, in
f32.  The equations, for layer i of kind ``layer_types[i]`` and x the
residual stream [S, d]:

* ``rms(x) = x * rsqrt(mean(x^2) + eps) * scale`` (eps ``rms_norm_eps``);
* attention: ``h = rms(x)``; ``q = h Wq``, ``k = h Wk``, ``v = h Wv`` (no
  bias), heads of ``head_dim``, ``num_key_value_heads`` of them shared by
  ``num_attention_heads / num_key_value_heads`` query heads each; RoPE on
  q and k, the two halves of a head rotated as pairs, ``cos(p w)`` and
  ``sin(p w)`` at position p with the kind's frequencies w
  (``rope_parameters[kind]``: ``w_j = theta^(-2j / head_dim)``; for
  ``yarn``, ``w_j = w_j / factor * r_j + w_j * (1 - r_j)`` with the ramp
  ``r_j = clamp((j - lo) / (hi - lo), 0, 1)`` between the dimensions
  ``lo = floor(D(beta_fast))`` and ``hi = ceil(D(beta_slow))``,
  ``D(t) = head_dim * ln(L / (2 pi t)) / (2 ln theta)`` at
  ``L = original_max_position_embeddings``, and cos and sin times
  ``attention_factor``); softmax of ``q k^T / sqrt(head_dim)`` over the
  keys at ``0 <= p - k``, and on a ``sliding_attention`` layer also
  ``p - k < sliding_window``; ``x += o Wo``;
* experts: ``h = rms(x)``; ``g = softmax(h W_r)`` over all
  ``num_experts_routed`` router outputs; the top ``num_experts_per_tok``
  of g, divided by their sum (``norm_topk_prob``);
  ``x += sum_e g_e W2_e(silu(W1_e h) * W3_e h)`` over the chosen experts
  that are held, ``experts_first_held`` to it plus ``num_experts``;
* logits: ``rms(x) W_out`` (untied).

Departures and assumptions, as the configuration's ``assumed`` lists
them: no qk-norm (the config has no such key); softmax gate scoring (the
config names none); the window as ``p - k < sliding_window``; the MTP
head left out (plain decoding does not use it); only the held share of
the experts, as the program computes it (one chip of the stated
expert-parallel deployment).

Weights are the benchmark's own tree: ``embed.table`` [vocab, d];
``blk{i}_attn``: ``ln.scale``, ``wq.w``, ``wk.w``, ``wv.w``, ``wo.w``
(each [in, out]); ``blk{i}_mlp``: ``ln.scale``, ``router`` [d, E],
``gate``, ``up`` [held, d, f], ``down`` [held, f, d]; ``head``:
``ln.scale``, ``out.w``.  ``tf32`` rounds every matrix product's operands
to TF32 first: the control's lower precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.resnet50 import _tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope_frequencies(rope: dict, head_dim: int,
                     device=None) -> tuple[torch.Tensor, float]:
    """(w [head_dim / 2], the cos and sin factor) of one section of
    ``rope_parameters``."""
    theta = float(rope["rope_theta"])
    j = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    w = 1.0 / theta ** (2 * j / head_dim)
    if rope.get("rope_type", "default") == "default":
        return w, 1.0
    assert rope["rope_type"] == "yarn", rope

    def dims(turns: float) -> float:
        return (head_dim * math.log(rope["original_max_position_embeddings"]
                                    / (2 * math.pi * turns))
                / (2 * math.log(theta)))
    lo = max(math.floor(dims(rope["beta_fast"])), 0)
    hi = min(math.ceil(dims(rope["beta_slow"])), head_dim - 1)
    r = ((j - lo) / max(hi - lo, 1e-3)).clamp(0, 1)
    return (w / rope["factor"] * r + w * (1 - r),
            float(rope["attention_factor"]))


def _rope(x: torch.Tensor, w: torch.Tensor, factor: float) -> torch.Tensor:
    """x [S, heads, hd] at positions 0 .. S-1."""
    S, _, hd = x.shape
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * w
    cos, sin = (torch.cos(ang)[:, None] * factor,
                torch.sin(ang)[:, None] * factor)
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def forward(params: dict, tokens: torch.Tensor, cfg: dict,
            tf32: bool = False) -> torch.Tensor:
    """Logits [S, vocab] of one sequence ``tokens`` [S] (int64), f32: row
    t is the prediction of token t + 1.  ``cfg`` holds the configuration
    file's keys."""
    mm = ((lambda a, b: _tf32(a) @ _tf32(b)) if tf32
          else (lambda a, b: a @ b))
    eps, hd = cfg["rms_norm_eps"], cfg["head_dim"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    top_k, first = cfg["num_experts_per_tok"], cfg["experts_first_held"]
    x = params["embed"]["table"][tokens]
    S = x.shape[0]
    p_k = (torch.arange(S, device=x.device)[:, None]
           - torch.arange(S, device=x.device)[None, :])
    for i, kind in enumerate(cfg["layer_types"]):
        p = params[f"blk{i}_attn"]
        w, factor = rope_frequencies(cfg["rope_parameters"][kind], hd,
                                     x.device)
        h = _rms(x, p["ln"]["scale"], eps)
        q = _rope(mm(h, p["wq"]["w"]).reshape(S, heads, hd), w, factor)
        k = _rope(mm(h, p["wk"]["w"]).reshape(S, kv, hd), w, factor)
        v = mm(h, p["wv"]["w"]).reshape(S, kv, hd)
        k = k.repeat_interleave(heads // kv, dim=1)
        v = v.repeat_interleave(heads // kv, dim=1)
        seen = p_k >= 0
        if kind == "sliding_attention":
            seen &= p_k < cfg["sliding_window"]
        att = mm(q.transpose(0, 1), k.permute(1, 2, 0)) / math.sqrt(hd)
        att = torch.softmax(att.masked_fill(~seen, float("-inf")), dim=-1)
        o = mm(att, v.transpose(0, 1)).transpose(0, 1).reshape(S, -1)
        del att
        x = x + mm(o, p["wo"]["w"])
        x = x + experts(params[f"blk{i}_mlp"], x, top_k, first, eps, mm)
    p = params["head"]
    return mm(_rms(x, p["ln"]["scale"], eps), p["out"]["w"])


def experts(p: dict, x: torch.Tensor, top_k: int, first: int, eps: float,
            mm=lambda a, b: a @ b) -> torch.Tensor:
    """The held experts' part of one expert layer's output for x [S, d]
    (without the residual)."""
    h = _rms(x, p["ln"]["scale"], eps)
    g = torch.softmax(mm(h, p["router"]), dim=-1)
    top, idx = torch.topk(g, top_k, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(p["up"].shape[0]):
        t, j = torch.nonzero(idx == first + e, as_tuple=True)
        if t.numel():
            he = h[t]
            a = F.silu(mm(he, p["gate"][e])) * mm(he, p["up"][e])
            y[t] += mm(a, p["down"][e]) * top[t, j, None]
    return y
