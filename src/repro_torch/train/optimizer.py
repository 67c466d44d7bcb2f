"""AdamW + warmup-cosine schedule + global-norm clipping on plain tensor
trees (the twin of ``repro.train.optimizer``).

The arithmetic is the reference's, in float32 and in its order of
operations, with the step count, learning rate, clip scale and bias
corrections as 0-d tensors on the parameters' device (no host sync).  The
update runs **in place**: ``apply_updates`` overwrites the parameters and
both moments and returns the same tree objects, where the reference
builds new trees.  At StarCoder2-3B's 3.03e9 parameters each float32 tree
is 12.1 GB; a second set of trees would not fit beside the first on one
card.  A caller who needs the pre-step parameters clones them first.
Each leaf is updated in flat chunks of at most ``CHUNK`` values, so the
update's temporaries stay small whatever the leaf (elementwise, so
the result does not depend on the chunking).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch

from repro_torch.core.graph import tree_leaves, tree_map

CHUNK = 1 << 24          # values per slice of a leaf in the update (64 MB)
NORM_CHUNK = 1 << 24     # values per slice of a leaf in global_norm


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (int or int32 tensor): linear warmup to
    ``lr``, then a cosine down to ``min_lr_frac · lr`` at
    ``total_steps``.  A float32 0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Any) -> dict:
    """Zero float32 moments shaped like ``params`` on their devices, and
    the step count, a 0-d int32 tensor."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _chunks(t: torch.Tensor, size: int | None = None
            ) -> Iterator[torch.Tensor]:
    return iter(t.reshape(-1).split(size or CHUNK))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32, the leaves in
    sorted-key order.  Each leaf is summed in slices of ``NORM_CHUNK``
    values (``torch.sum``'s own reduction within a slice: a float32 dot
    product accumulates 1e8 squares with a relative error of 1e-5)."""
    total = 0
    for leaf in tree_leaves(tree):
        for c in _chunks(leaf, NORM_CHUNK):
            total = total + torch.sum(torch.square(c.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, opt_state: dict, cfg: OptConfig):
    """One AdamW step, in place on ``params`` and ``opt_state``'s moments
    and step.  Returns (params, opt_state, {"grad_norm", "lr"}): the same
    tree objects, updated.  Weight decay applies to leaves of ndim >= 2
    only (the reference's rule, so a stacked per-layer norm scale [L, d]
    is decayed and ``final_ln.scale`` [d] is not)."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(_scalar(cfg.clip_norm, gnorm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(_scalar(cfg.b1, t), t)
    bc2 = 1 - torch.pow(_scalar(cfg.b2, t), t)

    flat_p = tree_leaves(params)
    for name, tree in (("grads", grads), ("mu", opt_state["mu"]),
                       ("nu", opt_state["nu"])):
        flat = tree_leaves(tree)
        if [tuple(x.shape) for x in flat] != [tuple(p.shape) for p in flat_p]:
            raise ValueError(f"apply_updates: {name} is not shaped like "
                             "params")
    for p, g, mu, nu in zip(flat_p, tree_leaves(grads),
                            tree_leaves(opt_state["mu"]),
                            tree_leaves(opt_state["nu"])):
        if not (p.is_contiguous() and mu.is_contiguous()
                and nu.is_contiguous()):
            raise ValueError("apply_updates: params and moments must be "
                             "contiguous (they are updated in place)")
        decay = p.dim() >= 2
        for pc, gc, mc, nc in zip(_chunks(p), _chunks(g), _chunks(mu),
                                  _chunks(nu)):
            g32 = gc.to(torch.float32) * scale
            mc.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            sq = g32 * (1 - cfg.b2)
            nc.mul_(cfg.b2).add_(sq.mul_(g32))
            del g32, sq
            u = mc / bc1
            den = nc / bc2
            u.div_(den.sqrt_().add_(cfg.eps))
            del den
            p32 = pc.to(torch.float32)
            if decay:
                u.add_(cfg.weight_decay * p32)
            u.mul_(lr)
            if pc.dtype == torch.float32:
                pc.sub_(u)
            else:
                pc.copy_((p32 - u).to(pc.dtype))
    step.add_(1)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
