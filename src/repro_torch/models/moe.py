"""Mixture-of-Experts block: top-k router and capacity-based dispatch (the
twin of ``repro.models.moe``).

* ``moe_block`` — global-view dispatch: every token's top-k assignments
  are scattered into one ``[E, C, d]`` capacity buffer, the experts run as
  dense per-expert products over it, and the slots are gathered back.
  With ``moe.token_shards = D`` the buffers are built per token shard
  (``_moe_block_sharded``).
* ``moe_block_local`` — expert parallelism (GShard-style) in one process:
  the expert axis is a list of ``ax`` shards, each with ``E / ax`` experts
  and the replicated router, and the reference's two ``all_to_all``s
  become an explicit exchange of ``[E_l, C, d]`` blocks in shard order.

Routing: softmax router, top-k (ties to the lower expert index, as
``jax.lax.top_k`` breaks them), gates renormalised over the chosen k,
GShard dropping at capacity ``C = ceil(T * k / E * capacity_factor)`` (at
least 4, a multiple of 4), and the reference's load-balance auxiliary
loss.  A
dropped assignment is added to slot ``C - 1`` as a zero row, so it never
disturbs the token kept there.

The expert products are ``torch.bmm`` / ``torch.einsum``: the reference
computes them with ``jnp.einsum`` outside any Pallas kernel.

``dispatch_record`` counts, by (tokens, capacity), the assignments every
dispatch made and dropped; the drop counts stay on the device.  While
``routing_log`` is a list, every dispatch also appends its expert indices
[T, k] to it, in dispatch order.  Tests and ``chip_smoke.py`` read them to
know where two runs may rightly differ (another token count, so another
capacity; a lossy relay that moves a routing decision); they change no
result.  A unit's forward run again by activation checkpointing records
nothing (``recording_off``).

``held_experts`` and ``held_experts_step`` are a dropless layer that holds
a contiguous share of the experts, as one chip of an expert-parallel
deployment does: it routes over every expert (softmax, top-k, gates
renormalised over the k) and adds only its held experts' part of the
result.  The first gathers each held expert's tokens (a prompt's
prefill); the second is the decode step's, at fixed shapes with no host
sync so that a CUDA graph captures it: every held expert over every row,
combined by weights that are zero where a row did not choose it.  Nothing
drops: the capacity is the step's rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.graph import current_step_rows
from repro_torch.models.layers import he_init, init_rmsnorm, rmsnorm


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    gated: bool
    moe: MoEConfig


def init_moe(rng: np.random.Generator, s: MoESpec, dtype) -> dict:
    E, d, f = s.moe.num_experts, s.d_model, s.d_ff
    p = {
        "ln": init_rmsnorm(d, dtype),
        "router": he_init(rng, (d, E), np.float32),
        "up": he_init(rng, (E, d, f), dtype, fan_in=d),
        "down": he_init(rng, (E, f, d), dtype, fan_in=f),
    }
    if s.gated:
        p["gate"] = he_init(rng, (E, d, f), dtype, fan_in=d)
    return p


def moe_param_count(s: MoESpec) -> int:
    E, d, f = s.moe.num_experts, s.d_model, s.d_ff
    return d + d * E + (3 if s.gated else 2) * E * d * f


# -- the dispatch record ---------------------------------------------------------

dispatch_record: dict[tuple[int, int], dict] = {}
routing_log: list | None = None
_recording = True


def reset_dispatch_record() -> None:
    dispatch_record.clear()


@contextlib.contextmanager
def recording_off():
    """Dispatches inside record nothing: the transformer's activation
    checkpointing runs a unit's forward again in the backward pass, and
    that recomputation is not a dispatch of its own."""
    global _recording
    prev, _recording = _recording, False
    try:
        yield
    finally:
        _recording = prev


def _record(tokens: int, capacity: int, idx: torch.Tensor,
            keep: torch.Tensor, dispatches: int = 1) -> None:
    if not _recording:
        return
    if routing_log is not None:
        routing_log.append(idx)
    r = dispatch_record.setdefault((tokens, capacity), {
        "dispatches": 0, "assignments": 0, "dropped": 0})
    r["dispatches"] += dispatches
    r["assignments"] += keep.numel()
    r["dropped"] = r["dropped"] + (~keep).sum()


def dropped() -> int:
    """Assignments dropped since the last reset, over every dispatch."""
    return sum(int(r["dropped"]) for r in dispatch_record.values())


# -- routing and dispatch ----------------------------------------------------------

def _route(p: dict, s: MoESpec, h_flat: torch.Tensor):
    """h_flat [T, d] -> (expert_idx [T, k], gates [T, k], aux_loss)."""
    logits = h_flat.to(torch.float32) @ p["router"]               # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert index, as jax.lax.top_k breaks
    # them (torch.topk does not promise it): a stable descending sort
    k = s.moe.top_k
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :k], order[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux as the reference writes it (top-1 fraction)
    E = s.moe.num_experts
    onehot = F.one_hot(idx[:, 0], E).to(torch.float32)
    aux = E * torch.mean(onehot.mean(0) * probs.mean(0)) * E
    return idx, gates.to(h_flat.dtype), aux


def _capacity(T: int, s: MoESpec) -> int:
    c = int(np.ceil(T * s.moe.top_k / s.moe.num_experts
                    * s.moe.capacity_factor))
    return max(4, ((c + 3) // 4) * 4)


def dispatch_indices(idx: torch.Tensor, E: int, C: int):
    """Slot positions via per-expert running count.  idx [T, k] ->
    (flat_expert [T*k], pos [T*k], keep [T*k])."""
    T, k = idx.shape
    flat = idx.reshape(T * k)
    onehot = F.one_hot(flat, E)                                   # [T*k, E]
    pos_in_e = torch.cumsum(onehot, dim=0) - 1
    pos = pos_in_e.gather(1, flat[:, None])[:, 0]
    keep = pos < C
    return flat, pos, keep


def _scatter(h: torch.Tensor, k: int, E: int, C: int, flat, pos, keep):
    """Each kept assignment's token row into its slot of an [E, C, d]
    buffer; a dropped one adds a zero row to slot C - 1."""
    pos = torch.where(keep, pos, C - 1)
    src = h.repeat_interleave(k, dim=0) * keep[:, None].to(h.dtype)
    buf = h.new_zeros((E, C, h.shape[-1]))
    buf.index_put_((flat, pos), src, accumulate=True)
    return buf, pos


def _combine(out_buf, flat, pos, keep, gates):
    """Gather each assignment's slot and sum them over k, gate-weighted,
    in top-k order: -> [T, d]."""
    T, k = gates.shape
    slots = out_buf[flat, pos] * keep[:, None].to(out_buf.dtype)
    return (slots.reshape(T, k, -1) * gates[:, :, None]).sum(dim=1)


def _expert_ffn(p: dict, s: MoESpec, buf: torch.Tensor) -> torch.Tensor:
    """buf [E, C, d] -> [E, C, d], dense per-expert products."""
    up = torch.bmm(buf, p["up"])
    if s.gated:
        up = F.silu(torch.bmm(buf, p["gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return torch.bmm(up, p["down"])


def moe_block(p: dict, s: MoESpec, x: torch.Tensor, eps: float = 1e-5):
    """x [B,S,d] -> ([B,S,d], aux_loss).  With ``moe.token_shards = D``
    the capacity buffers are built per token shard."""
    if s.moe.token_shards > 1:
        return _moe_block_sharded(p, s, x, eps, s.moe.token_shards)
    B, S, d = x.shape
    T = B * S
    h = rmsnorm(p["ln"], x, eps).reshape(T, d)
    idx, gates, aux = _route(p, s, h)
    E, k = s.moe.num_experts, s.moe.top_k
    C = _capacity(T, s)
    flat, pos, keep = dispatch_indices(idx, E, C)
    _record(T, C, idx, keep)
    buf, pos = _scatter(h, k, E, C, flat, pos, keep)
    y = _combine(_expert_ffn(p, s, buf), flat, pos, keep, gates)
    return x + y.reshape(B, S, d), aux


def _moe_block_sharded(p: dict, s: MoESpec, x: torch.Tensor, eps: float,
                       D: int):
    """Per-token-shard dispatch: buf [D, E, C_l, d], each shard's scatter
    over its own tokens at C_l = capacity(T / D).  Equal to the global
    dispatch where no shard overflows its capacity.  (The reference's
    sharding hints are no-ops without a mesh.)"""
    B, S, d = x.shape
    T = B * S
    E, k = s.moe.num_experts, s.moe.top_k
    h = rmsnorm(p["ln"], x, eps).reshape(T, d)
    idx, gates, aux = _route(p, s, h)
    T_l = T // D
    C_l = _capacity(T_l, s)
    idx_s = idx.reshape(D, T_l, k)
    parts = [dispatch_indices(idx_s[i], E, C_l) for i in range(D)]
    flat, pos, keep = (torch.stack(t) for t in zip(*parts))   # [D, T_l*k]
    _record(T_l, C_l, idx, keep, dispatches=D)
    pos = torch.where(keep, pos, C_l - 1)
    src = h.reshape(D, T_l, d).repeat_interleave(k, dim=1) \
        * keep[..., None].to(h.dtype)                          # [D, T_l*k, d]
    buf = h.new_zeros((D, E, C_l, d))
    didx = torch.arange(D, device=h.device)[:, None].expand_as(flat)
    buf.index_put_((didx, flat, pos), src, accumulate=True)   # local scatter
    up = torch.einsum("xecd,edf->xecf", buf, p["up"])
    if s.gated:
        up = F.silu(torch.einsum("xecd,edf->xecf", buf, p["gate"])) * up
    else:
        up = F.gelu(up, approximate="tanh")
    out_buf = torch.einsum("xecf,efd->xecd", up, p["down"])
    slots = out_buf[didx, flat, pos] * keep[..., None].to(h.dtype)
    y = (slots.reshape(D, T_l, k, d)
         * gates.reshape(D, T_l, k)[..., None]).sum(dim=2)
    return x + y.reshape(B, S, d), aux


# -- expert parallelism in one process --------------------------------------------

def moe_block_local(ps: Sequence[dict], s: MoESpec,
                    xs: Sequence[torch.Tensor], eps: float = 1e-5):
    """Expert-parallel MoE over ``ax = len(ps)`` shards, driven from this
    process.  Shard i holds ``ps[i]`` (the replicated ``ln`` and
    ``router``; ``up`` / ``gate`` / ``down`` with leading dim E_l = E / ax,
    experts [i*E_l, (i+1)*E_l)) and its tokens ``xs[i]`` [B_l, S_l, d].

    Each shard dispatches its tokens into an [E, C, d] buffer; the buffers
    are exchanged so that shard j receives every shard's [E_l, C, d] block
    of its experts, in shard order (the reference's first ``all_to_all``);
    each shard runs its experts over [E_l, ax*C, d]; the results go back
    the same way (the second); each shard combines its own tokens.
    Returns ([y_i [B_l, S_l, d]], [aux_i]); shard i's output equals the
    reference's ``moe_block_local`` on device i of the expert axis."""
    ax = len(ps)
    E, k = s.moe.num_experts, s.moe.top_k
    if E % ax:
        raise ValueError(f"{E} experts do not divide over {ax} shards")
    if len({tuple(x.shape) for x in xs}) != 1 or len(xs) != ax:
        raise ValueError("every shard needs tokens of one shape: "
                         f"{[tuple(x.shape) for x in xs]} over {ax} shards")
    E_l = E // ax
    routed, bufs = [], []
    for p, x_l in zip(ps, xs):
        B_l, S_l, d = x_l.shape
        T_l = B_l * S_l
        h = rmsnorm(p["ln"], x_l, eps).reshape(T_l, d)
        idx, gates, aux = _route(p, s, h)
        C = _capacity(T_l, s)
        flat, pos, keep = dispatch_indices(idx, E, C)
        _record(T_l, C, idx, keep)
        buf, pos = _scatter(h, k, E, C, flat, pos, keep)
        routed.append((flat, pos, keep, gates, aux))
        bufs.append(buf.reshape(ax, E_l, C, d))
    C = bufs[0].shape[2]
    outs = []
    for j, p in enumerate(ps):           # shard j's experts, every sender
        dev = p["up"].device
        recv = torch.stack([b[j].to(dev) for b in bufs])    # [ax, E_l, C, d]
        recv = recv.movedim(0, 1).reshape(E_l, ax * C, -1)
        out = _expert_ffn(p, s, recv)                        # [E_l, ax*C, d]
        outs.append(out.reshape(E_l, ax, C, -1).movedim(1, 0))
    ys, auxes = [], []
    for i, x_l in enumerate(xs):         # shard i's slots from every owner
        back = torch.cat([o[i].to(x_l.device) for o in outs])    # [E, C, d]
        flat, pos, keep, gates, aux = routed[i]
        y = _combine(back, flat, pos, keep, gates)
        ys.append(x_l + y.reshape(x_l.shape))
        auxes.append(aux)
    return ys, auxes


def moe_flops(s: MoESpec, tokens: int) -> float:
    mats = 3 if s.gated else 2
    active = 2.0 * mats * s.d_model * s.d_ff * s.moe.top_k
    router = 2.0 * s.d_model * s.moe.num_experts
    return tokens * (active * s.moe.capacity_factor + router)


# -- a held share of the experts, dropless ------------------------------------------

def route_topk(p: dict, h: torch.Tensor, top_k: int):
    """h [T, d] -> (expert_idx [T, k] over every expert of the router,
    gates [T, k]): softmax over all of them, the top k (ties to the lower
    index), divided by their sum."""
    probs = torch.softmax(h @ p["router"], dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :top_k]
    return order[:, :top_k], gates / gates.sum(-1, keepdim=True)


def _swiglu(p: dict, h: torch.Tensor, e: int) -> torch.Tensor:
    return (F.silu(h @ p["gate"][e]) * (h @ p["up"][e])) @ p["down"][e]


def held_experts(p: dict, x: torch.Tensor, top_k: int, first: int,
                 eps: float = 1e-5) -> torch.Tensor:
    """x [B,S,d] -> x + the held experts' part of the routed SwiGLU
    experts' sum, each held expert over the tokens that chose it.

    ``p``: ``ln``, ``router`` [d, E] over all E experts, and ``gate`` /
    ``up`` [n, d, f], ``down`` [n, f, d] of experts ``[first, first + n)``."""
    B, S, d = x.shape
    h = rmsnorm(p["ln"], x, eps).reshape(B * S, d)
    idx, gates = route_topk(p, h, top_k)
    n = p["up"].shape[0]
    local = (idx - first).reshape(-1)
    held = (local >= 0) & (local < n)
    # assignments grouped by held expert; one host read of the counts
    order = torch.argsort(torch.where(held, local, n), stable=True)
    counts = torch.bincount(local[held], minlength=n).tolist()
    y = torch.zeros_like(h)
    at = 0
    for e, c in enumerate(counts):
        if c:
            a = order[at:at + c]
            rows = a // top_k
            y.index_add_(0, rows, _swiglu(p, h[rows], e)
                         * gates.reshape(-1)[a, None])
            at += c
    return x + y.reshape(B, S, d)


def held_experts_step(p: dict, x: torch.Tensor, top_k: int, first: int,
                      name: str, eps: float = 1e-5) -> torch.Tensor:
    """:func:`held_experts` for a decode step's rows x [T, 1, d], at fixed
    shapes: every held expert runs over every row, and a row's output is
    weighted by its gate where it chose the expert and by 0 elsewhere.

    Inside a replica's step (:func:`current_step_rows`) it adds layer
    ``name``'s tallies: ``moe_rows`` [n], per held expert the live rows
    routed to it, and ``moe_dropped``, the live rows' assignments to held
    experts whose weight in the combine is 0 (none: a gate is positive)."""
    T, S, d = x.shape
    h = rmsnorm(p["ln"], x, eps).reshape(T * S, d)
    idx, gates = route_topk(p, h, top_k)
    n = p["up"].shape[0]
    local = idx - first
    held = (local >= 0) & (local < n)
    col = torch.where(held, local, n)             # the others: a spare column
    w = combine_weights(col, torch.where(held, gates, 0.0), n)
    hb = h.expand(n, T * S, d)
    a = F.silu(torch.bmm(hb, p["gate"])) * torch.bmm(hb, p["up"])
    out = torch.bmm(a, p["down"])                 # [n, T, d]
    y = (out * w.t()[:, :, None]).sum(0)
    rows = current_step_rows()
    if rows is not None:
        chose = torch.zeros((T * S, n + 1), dtype=torch.bool,
                            device=x.device).scatter_(1, col, held)[:, :n]
        chose &= rows.live[:, None].bool()
        rows.tally("moe_rows", name, (n,)).add_(chose.sum(0))
        rows.tally("moe_dropped", name).add_((chose & (w == 0)).sum())
    return x + y.reshape(T, S, d)


def combine_weights(col: torch.Tensor, gates: torch.Tensor,
                    n: int) -> torch.Tensor:
    """[T, n]: row t's gate for held expert e where one of its k choices
    (``col`` [T, k], n for an expert not held) is e, else 0."""
    return gates.new_zeros((col.shape[0], n + 1)).scatter_(
        1, col, gates)[:, :n]


def held_experts_flops(d: int, f: int, top_k: int, num_experts: int,
                       held: int, tokens: int) -> float:
    """Routed work of ``held`` of ``num_experts`` experts, at their share
    of the top-k assignments, and the router's."""
    return tokens * 2.0 * d * (3 * f * top_k * held / num_experts
                               + num_experts)
