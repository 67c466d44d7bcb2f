"""Composable transformer LM over the assigned families (the twin of
``repro.models.transformer``).

Families map to a repeating *unit* of layers whose parameters are stacked
along a leading unit axis, in the reference's tree:

* dense / vlm    unit = ``len(window_pattern)`` (attn + MLP) layers
                 (gemma3: 5 sliding-window + 1 global per unit)
* ssm            unit = 1 Mamba2 layer
* hybrid         unit = ``hybrid_unit`` Mamba2 layers + the SHARED
                 (weight-tied) attention+MLP block (zamba2)
* encdec / audio separate encoder and decoder unit stacks; decoder units
                 add cross-attention over the encoder output
* moe            unit = 1 (attn + MoE) layer

``num_layers % unit`` remainder layers are stored in a small stack of
single-layer units.  The reference scans the units with ``lax.scan``; the
port loops over the unit axis in Python.

Entry points:
  ``forward``      train/prefill logits (+ aux loss, 0 without MoE)
  ``loss_fn``      next-token cross entropy (+ router aux) for training
  ``prefill``      forward + KV/SSM caches for subsequent decode
  ``decode_step``  one token through all layers with caches (serve step)

Under autograd, ``cfg.remat`` runs each unit under activation
checkpointing, as the reference's ``jax.checkpoint`` over its scan body.

``init_lm`` and ``init_caches`` create tensors on the device that
:func:`repro_torch.device.get_device` resolves (CUDA unless the caller
asks for the CPU); the apply functions run on the device of the tensors
they are given.  ``abstract_params`` gives ``init_lm``'s tree as meta
tensors (shapes and dtypes, nothing drawn): the reference's
``jax.eval_shape`` tree, for configs too large to draw.
``params_from_jax`` / ``caches_from_jax`` carry the JAX package's trees
(as numpy) over with no relayout, so a JAX prefill's SSM, conv and KV
states can be stepped by the port.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graph import tree_leaves, tree_map
from repro_torch.device import get_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import AttnSpec
from repro_torch.models.moe import MoESpec
from repro_torch.models.ssm import MambaSpec

NEG_INF = -1e30


# -- specs ---------------------------------------------------------------------

def attn_spec(cfg: ModelConfig, window: int | None, causal: bool = True) -> AttnSpec:
    return AttnSpec(cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.head_dim,
                    cfg.rope_theta, window, causal)


def moe_spec(cfg: ModelConfig) -> MoESpec:
    return MoESpec(cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.moe)


def mamba_spec(cfg: ModelConfig) -> MambaSpec:
    return MambaSpec(cfg.d_model, cfg.ssm)


def _window_at(cfg: ModelConfig, i: int) -> int | None:
    return cfg.window_pattern[i % len(cfg.window_pattern)]


def _unit_count(cfg: ModelConfig) -> tuple[int, int]:
    u = cfg.unit_layers
    return cfg.num_layers // u, cfg.num_layers % u


# -- trees ------------------------------------------------------------------------

def _stack(trees: list, stack=torch.stack):
    """Leaf-wise stack of same-structure trees along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], stack) for k in first}
    return stack(trees)


def _tree_at(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _to_torch(a, device: torch.device) -> torch.Tensor:
    """A copy of a host array as a tensor on ``device`` (the port updates
    caches in place, so it never shares the caller's memory); a numpy
    bfloat16 array (JAX's) goes through float32, which holds every
    bfloat16 exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_jax(params: dict, device: str | torch.device | None = None
                    ) -> dict:
    """The JAX package's ``init_lm`` tree (leaves as numpy arrays) as the
    port's, on ``device``: same names, shapes and layouts."""
    dev = get_device(device)
    return tree_map(lambda a: _to_torch(a, dev), params)


def caches_from_jax(caches: dict, device: str | torch.device | None = None
                    ) -> dict:
    """The JAX package's ``prefill`` / ``init_caches`` tree (leaves as
    numpy arrays) as the port's, on ``device``: the SSM and conv states,
    KV caches with their ``kpos`` and the encoder output, unchanged."""
    dev = get_device(device)
    return tree_map(lambda a: _to_torch(a, dev), caches)


# -- init -------------------------------------------------------------------------

def _init_layer(rng: np.random.Generator, cfg: ModelConfig, pos_in_unit: int,
                dtype, encoder: bool = False) -> dict:
    if cfg.family in ("ssm", "hybrid") and not encoder:
        return {"mamba": ssm_mod.init_mamba(rng, mamba_spec(cfg), dtype)}
    out: dict[str, Any] = {
        "attn": attn_mod.init_attn(
            rng, attn_spec(cfg, _window_at(cfg, pos_in_unit),
                           causal=not encoder), dtype),
    }
    if cfg.moe and not encoder:
        out["moe"] = moe_mod.init_moe(rng, moe_spec(cfg), dtype)
    else:
        out["mlp"] = L.init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                dtype)
    if cfg.encoder_layers and not encoder:
        out["cross"] = attn_mod.init_cross_attn(
            rng, attn_spec(cfg, None, causal=False), dtype)
    return out


def _init_unit(rng, cfg: ModelConfig, dtype, encoder: bool = False) -> dict:
    u = 1 if encoder else cfg.unit_layers
    return {f"pos{i}": _init_layer(rng, cfg, i, dtype, encoder)
            for i in range(u)}


def _pad_rows(table: np.ndarray, rows: int) -> np.ndarray:
    """Zero-pad dim 0 to ``rows``.  Pad rows MUST be zero (not random):
    tied-embedding logits are x @ table.T, and the padded ids are masked
    to -1e30 in the logits."""
    if table.shape[0] == rows:
        return table
    pad = np.zeros((rows - table.shape[0],) + table.shape[1:], table.dtype)
    return np.concatenate([table, pad], axis=0)


# float32 whatever the dtype
_F32_LEAVES = ("A_log", "D", "dt_bias", "router")


class _Shape:
    """A drawn leaf's shape and dtype without its values: what
    :class:`_ShapeRng` draws, through the initializers' arithmetic and
    ``init_lm``'s padding and stacking (``np.concatenate`` / ``np.stack``)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)

    def __mul__(self, other):
        return self

    def astype(self, dtype):
        return _Shape(self.shape, dtype)

    @property
    def T(self):
        return _Shape(self.shape[::-1], self.dtype)

    def __array_function__(self, func, types, args, kwargs):
        arrs = args[0]
        if func is np.stack:
            return _Shape((len(arrs),) + arrs[0].shape, arrs[0].dtype)
        if func is np.concatenate:
            return _Shape((sum(a.shape[0] for a in arrs),)
                          + arrs[0].shape[1:], arrs[0].dtype)
        return NotImplemented


class _ShapeRng:
    """Stands in for the numpy generator in :func:`abstract_params`."""

    def standard_normal(self, shape, dtype):
        return _Shape(shape, dtype)


def _place(tree, dtype: torch.dtype, dev: torch.device, key=None):
    if isinstance(tree, dict):
        return {k: _place(v, dtype, dev, k) for k, v in tree.items()}
    dt = torch.float32 if key in _F32_LEAVES else dtype
    if isinstance(tree, _Shape):
        return torch.empty(tree.shape, dtype=dt, device=dev)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(dev).to(dt)


def init_lm(cfg: ModelConfig, rng: np.random.Generator | int = 0,
            dtype: torch.dtype = torch.float32,
            device: str | torch.device | None = None) -> dict:
    """Seeded parameters in the reference's tree, drawn with numpy (float32)
    and placed on ``device`` in ``dtype``.  The draws follow the
    reference's initializers, not its random stream: parity tests carry
    the reference's own weights over with :func:`params_from_jax`."""
    return _build_params(cfg, np.random.default_rng(rng), dtype,
                         get_device(device))


def abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16
                    ) -> dict:
    """``init_lm``'s tree as meta tensors, without drawing or allocating
    anything: shapes and dtypes for configs too large to draw (dbrx-132b
    is 490 GiB in f32).  The reference's default dtype."""
    return _build_params(cfg, _ShapeRng(), dtype, torch.device("meta"))


def _build_params(cfg: ModelConfig, rng, dtype: torch.dtype,
                  dev: torch.device) -> dict:
    f32 = np.float32
    n_units, rem = _unit_count(cfg)
    embed = L.init_embedding(rng, cfg.vocab, cfg.d_model, f32)
    embed["table"] = _pad_rows(embed["table"], cfg.padded_vocab)
    params: dict[str, Any] = {
        "embed": embed,
        "units": _stack([_init_unit(rng, cfg, f32) for _ in range(n_units)],
                        np.stack),
        "final_ln": L.init_rmsnorm(cfg.d_model, f32),
    }
    if rem:
        # remainder layers: stacked single-layer units (window is an
        # apply-time property, so all share pos-0 param shapes)
        params["rem"] = _stack([{"pos0": _init_layer(rng, cfg, 0, f32)}
                                for _ in range(rem)], np.stack)
    if cfg.family == "hybrid":
        params["shared"] = {
            "attn": attn_mod.init_attn(rng, attn_spec(cfg, None), f32),
            "mlp": L.init_mlp(rng, cfg.d_model, cfg.d_ff, cfg.gated_mlp, f32),
        }
    if cfg.encoder_layers:
        params["enc_units"] = _stack(
            [_init_unit(rng, cfg, f32, encoder=True)
             for _ in range(cfg.encoder_layers)], np.stack)
    if not cfg.tie_embeddings:
        unembed = L.init_linear(rng, cfg.d_model, cfg.vocab, f32)
        unembed["w"] = _pad_rows(unembed["w"].T, cfg.padded_vocab).T
        params["unembed"] = unembed

    return _place(params, dtype, dev)


def param_count(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


# -- apply -------------------------------------------------------------------------

def _unbind(tree) -> list:
    """The stacked tree split once along its unit axis: one tree of views
    per unit.  Under autograd the split's backward is one ``stack``, where
    indexing the stack once per unit would add a zero-filled gradient as
    large as the whole stack for every unit."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


# what the "dots" policy keeps from a unit's forward: every matmul output
# (``jax.checkpoint_policies.dots_saveable``); the rest is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _checkpointed(body, remat_policy: str):
    """``body`` under activation checkpointing: "full" saves nothing of
    a unit's forward but its inputs, "dots" also its matmul outputs.  The
    forward that checkpointing runs again in the backward pass records no
    moe dispatch."""
    if remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy {remat_policy!r}: 'full' or 'dots'")
    from torch.utils import checkpoint as ckpt
    context_fn = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    list(_DOTS))
                  if remat_policy == "dots" else ckpt.noop_context_fn)

    def run(carry, up):
        calls = []

        def once(carry, up):
            calls.append(None)
            if len(calls) == 1:
                return body(carry, up)
            with moe_mod.recording_off():
                return body(carry, up)

        return ckpt.checkpoint(once, carry, up, use_reentrant=False,
                               context_fn=context_fn)

    return run


def _scan_units(body, carry, units, remat: bool = False, unroll: bool = False,
                remat_policy: str = "full"):
    """Run ``body`` over the stacked-unit axis: ``lax.scan`` in the
    reference, a Python loop here whatever ``unroll`` says.  With
    ``remat`` and grad enabled each unit runs under activation
    checkpointing (``remat_policy`` says what it keeps), as the
    reference's ``jax.checkpoint`` does; without grad nothing is kept
    for a backward pass anyway, and the body runs as it is."""
    del unroll
    if remat and torch.is_grad_enabled():
        body = _checkpointed(body, remat_policy)
    ys = []
    for up in _unbind(units):
        carry, y = body(carry, up)
        ys.append(y)
    if ys and ys[0] is not None:
        return carry, _stack(ys)
    return carry, None


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _apply_layer(lp: dict, cfg: ModelConfig, x, positions, aux, window,
                 enc_out=None, use_kernel=False, encoder=False):
    if "mamba" in lp:
        x = ssm_mod.mamba_block(lp["mamba"], mamba_spec(cfg), x,
                                cfg.norm_eps, use_kernel)
        return x, aux
    s = attn_spec(cfg, window, causal=not encoder)
    x = attn_mod.attention(lp["attn"], s, x, positions, cfg.norm_eps)
    if "cross" in lp and enc_out is not None:
        x = attn_mod.cross_attention(lp["cross"], attn_spec(cfg, None, False),
                                     x, enc_out, eps=cfg.norm_eps)
    if "moe" in lp:
        x, a = moe_mod.moe_block(lp["moe"], moe_spec(cfg), x, cfg.norm_eps)
        aux = aux + a
    else:
        x = L.mlp(lp["mlp"], x, cfg.norm_eps)
    return x, aux


def _apply_unit(up: dict, cfg: ModelConfig, x, positions, aux, shared=None,
                enc_out=None, use_kernel=False, encoder=False):
    n_pos = 1 if encoder else cfg.unit_layers
    for i in range(n_pos):
        x, aux = _apply_layer(up[f"pos{i}"], cfg, x, positions, aux,
                              _window_at(cfg, i), enc_out, use_kernel, encoder)
    if shared is not None:
        x = attn_mod.attention(shared["attn"], attn_spec(cfg, None), x,
                               positions, cfg.norm_eps)
        x = L.mlp(shared["mlp"], x, cfg.norm_eps)
    return x, aux


def _fuse_prefix(cfg: ModelConfig, x, prefix_embeds):
    if prefix_embeds is None or cfg.num_prefix_embeds == 0:
        return x
    n = prefix_embeds.shape[1]
    return torch.cat([prefix_embeds.to(x.dtype), x[:, n:]], dim=1)


def _encode(params, cfg: ModelConfig, encoder_embeds, use_kernel=False,
            unroll=False):
    x = encoder_embeds
    B, Se, _ = x.shape
    positions = _positions(B, Se, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(carry, up):
        h, a = carry
        h, a = _apply_unit(up, cfg, h, positions, a, use_kernel=use_kernel,
                           encoder=True)
        return (h, a), None

    (x, aux), _ = _scan_units(body, (x, aux), params["enc_units"],
                              remat=cfg.remat, unroll=unroll,
                              remat_policy=cfg.remat_policy)
    return x, aux


def _logits(params, cfg: ModelConfig, x):
    x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
    logits = (L.unembed(params["embed"], x) if cfg.tie_embeddings
              else L.linear(params["unembed"], x))
    return _mask_pad_vocab(cfg, logits)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds=None, encoder_embeds=None, use_kernel=False,
            unroll=False):
    """tokens [B,S] -> logits [B,S,V]; returns (logits, aux_loss).

    ``use_kernel`` runs every Mamba layer's SSD scan as the port's CUDA
    kernel; ``unroll`` is the reference's choice between a scan and an
    unrolled loop, and the port always loops."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    x = _fuse_prefix(cfg, x, prefix_embeds)
    positions = _positions(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    enc_out = None
    if cfg.encoder_layers:
        if encoder_embeds is None:
            raise ValueError("enc-dec model needs encoder_embeds")
        enc_out, enc_aux = _encode(params, cfg, encoder_embeds, use_kernel,
                                   unroll)
        aux = aux + enc_aux

    shared = params.get("shared")

    def body(carry, up):
        h, a = carry
        h, a = _apply_unit(up, cfg, h, positions, a, shared=shared,
                           enc_out=enc_out, use_kernel=use_kernel)
        return (h, a), None

    (x, aux), _ = _scan_units(body, (x, aux), params["units"],
                              remat=cfg.remat, unroll=unroll,
                              remat_policy=cfg.remat_policy)

    _, rem = _unit_count(cfg)
    if rem:
        for i, up in enumerate(_unbind(params["rem"])):
            x, aux = _apply_layer(up["pos0"], cfg, x, positions, aux,
                                  _window_at(cfg, i), enc_out, use_kernel)
    return _logits(params, cfg, x), aux


def _mask_pad_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded-vocab ids get -1e30 so softmax/argmax semantics are exact."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(ids < cfg.vocab, logits,
                       torch.tensor(NEG_INF, dtype=logits.dtype,
                                    device=logits.device))


def loss_fn(params, cfg: ModelConfig, batch: dict, use_kernel=False,
            unroll=False):
    """Next-token cross entropy over the labels >= 0 (+ the router's aux
    loss times ``router_aux_weight`` for moe) -> (loss, {"nll", "aux"}).
    A negative label is masked out; it is clamped to 0 before the gather,
    since a gather at -1 is a device-side assert on CUDA."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("prefix_embeds"),
                          batch.get("encoder_embeds"), use_kernel, unroll)
    labels = batch["labels"]
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    return loss + w * aux, {"nll": loss, "aux": aux}


# -- caches / decode -------------------------------------------------------------

def _attn_cache(s: AttnSpec, batch: int, max_len: int, dtype, quant: bool,
                dev) -> dict:
    c = attn_mod.init_cache(s, batch, max_len, dtype, quant=quant, device=dev)
    c["kpos"] = torch.full((batch, c["k"].shape[1]), -1, dtype=torch.int32,
                           device=dev)
    return c


def _init_layer_cache(cfg: ModelConfig, pos_in_unit: int, batch: int,
                      max_len: int, dtype, lp_kind: str, dev) -> dict:
    if lp_kind == "mamba":
        return ssm_mod.init_mamba_cache(mamba_spec(cfg), batch, dtype, dev)
    return _attn_cache(attn_spec(cfg, _window_at(cfg, pos_in_unit)), batch,
                       max_len, dtype, cfg.kv_cache_quant, dev)


def _layer_kind(cfg: ModelConfig) -> str:
    return "mamba" if cfg.family in ("ssm", "hybrid") else "attn"


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> dict:
    """Empty decode caches on ``device`` in the reference's tree."""
    dev = get_device(device)
    n_units, rem = _unit_count(cfg)
    kind = _layer_kind(cfg)

    def unit_cache():
        c = {f"pos{i}": _init_layer_cache(cfg, i, batch, max_len, dtype, kind,
                                          dev)
             for i in range(cfg.unit_layers)}
        if cfg.family == "hybrid":
            c["shared"] = _attn_cache(attn_spec(cfg, None), batch, max_len,
                                      dtype, False, dev)
        return c

    caches: dict[str, Any] = {
        "units": _stack([unit_cache() for _ in range(n_units)]),
    }
    if rem:
        # rem layer i uses window _window_at(cfg, i); cache sized per pos0
        caches["rem"] = _stack([
            {"pos0": _init_layer_cache(cfg, 0, batch, max_len, dtype, kind,
                                       dev)} for _ in range(rem)])
    if cfg.encoder_layers:
        caches["enc_out"] = torch.zeros(
            (batch, cfg.num_prefix_embeds, cfg.d_model), dtype=dtype,
            device=dev)
    return caches


def _decode_layer(lp, cfg, x, pos, cache, window, enc_out, use_kernel):
    if "mamba" in lp:
        return ssm_mod.mamba_decode(lp["mamba"], mamba_spec(cfg), x, cache,
                                    cfg.norm_eps)
    s = attn_spec(cfg, window)
    x, nkv, nkpos = attn_mod.attention_decode(
        lp["attn"], s, x, pos, cache, cache["kpos"], cfg.norm_eps, use_kernel)
    nc = {**nkv, "kpos": nkpos}
    if "cross" in lp and enc_out is not None:
        x = attn_mod.cross_attention(lp["cross"], attn_spec(cfg, None, False),
                                     x, enc_out, eps=cfg.norm_eps)
    if "moe" in lp:
        x, _ = moe_mod.moe_block(lp["moe"], moe_spec(cfg), x, cfg.norm_eps)
    else:
        x = L.mlp(lp["mlp"], x, cfg.norm_eps)
    return x, nc


def _write_back(dst: dict, src: dict) -> None:
    """Copy a layer's new cache into its slot of the stacked caches (the
    attention layers already wrote theirs in place)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write_back(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


def decode_step(params: dict, cfg: ModelConfig, token: torch.Tensor,
                pos: torch.Tensor, caches: dict, use_kernel=False,
                unroll=False):
    """One serve step: token [B,1] (ids), pos [B] int32 -> (logits [B,1,V],
    caches).

    Where the reference returns new caches, the port writes each layer's
    new state (and the new KV slot) into ``caches`` in place and returns
    it: a copy of every cache per step would double the step's memory
    traffic.  ``use_kernel`` runs decode attention as the port's CUDA
    kernel; Mamba layers step their O(1) recurrence in plain PyTorch, as
    the reference does.  ``unroll`` changes nothing (the port loops)."""
    x = L.embed(params["embed"], token)
    enc_out = caches.get("enc_out")
    shared = params.get("shared")
    n_units, rem = _unit_count(cfg)

    for u in range(n_units):
        up = _tree_at(params["units"], u)
        uc = _tree_at(caches["units"], u)
        for i in range(cfg.unit_layers):
            x, nc = _decode_layer(up[f"pos{i}"], cfg, x, pos, uc[f"pos{i}"],
                                  _window_at(cfg, i), enc_out, use_kernel)
            _write_back(uc[f"pos{i}"], nc)
        if shared is not None:
            sc = uc["shared"]
            x, nkv, nkpos = attn_mod.attention_decode(
                shared["attn"], attn_spec(cfg, None), x, pos, sc, sc["kpos"],
                cfg.norm_eps, use_kernel)
            x = L.mlp(shared["mlp"], x, cfg.norm_eps)
            _write_back(sc, {**nkv, "kpos": nkpos})

    for i in range(rem):
        up = _tree_at(params["rem"], i)
        uc = _tree_at(caches["rem"], i)
        x, nc = _decode_layer(up["pos0"], cfg, x, pos, uc["pos0"],
                              _window_at(cfg, i), enc_out, use_kernel)
        _write_back(uc["pos0"], nc)

    return _logits(params, cfg, x), caches


# -- prefill ----------------------------------------------------------------------

def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds=None, encoder_embeds=None, max_len: int | None = None,
            use_kernel=False, unroll=False):
    """Run the full prompt, returning (last_logits, caches) for decode.

    Layer by layer as ``forward`` runs, collecting each layer's cache: a
    Mamba layer's final SSD state and conv tail, an attention layer's K/V
    (re-projected once more) in a cache of ``max_len`` slots (the window's
    for sliding-window layers) with its ``kpos``.  ``use_kernel`` runs the
    SSD scan as the port's CUDA kernel."""
    B, S = tokens.shape
    max_len = max_len or S
    x = L.embed(params["embed"], tokens)
    x = _fuse_prefix(cfg, x, prefix_embeds)
    dev = x.device
    positions = _positions(B, S, dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    enc_out = None
    if cfg.encoder_layers:
        enc_out, _ = _encode(params, cfg, encoder_embeds, use_kernel, unroll)

    dtype = x.dtype
    shared = params.get("shared")

    def prefill_layer(lp, h, window):
        """returns (new_h, cache)"""
        if "mamba" in lp:
            mp, ms = lp["mamba"], mamba_spec(cfg)
            hh = L.rmsnorm(mp["ln"], h, cfg.norm_eps)
            z, xBC, dt_raw = ssm_mod._split_proj(ms, hh @ mp["in_proj"])
            xBC_c, conv_state = ssm_mod._causal_conv(xBC, mp["conv_w"],
                                                     mp["conv_b"])
            di, N = ms.d_inner, ms.ssm.state_dim
            xs = xBC_c[..., :di].reshape(B, S, ms.n_heads, ms.ssm.head_dim)
            Bm = xBC_c[..., di:di + N]
            Cm = xBC_c[..., di + N:]
            dt = torch.nn.functional.softplus(dt_raw.to(torch.float32)
                                              + mp["dt_bias"])
            A = -torch.exp(mp["A_log"])
            y, state = ssm_mod.ssd_chunked(xs, dt, A, Bm, Cm, ms.ssm.chunk,
                                           use_kernel=use_kernel)
            y = y + xs * mp["D"].to(h.dtype)[None, None, :, None]
            y = y.reshape(B, S, di)
            y = L.rmsnorm(mp["norm"], y * torch.nn.functional.silu(z),
                          cfg.norm_eps)
            return h + y @ mp["out_proj"], {"conv": conv_state, "ssd": state}
        # attention layer: compute forward and fill cache
        s = attn_spec(cfg, window)
        out = attn_mod.attention(lp["attn"], s, h, positions, cfg.norm_eps)
        hh = L.rmsnorm(lp["attn"]["ln"], h, cfg.norm_eps)
        _, k, v = attn_mod._project_qkv(lp["attn"], s, hh, positions)
        C = min(max_len, s.window) if s.window else max_len
        ck = torch.zeros((B, C, s.kv_heads, s.head_dim), dtype=dtype,
                         device=dev)
        cv = torch.zeros_like(ck)
        kpos = torch.full((B, C), -1, dtype=torch.int32, device=dev)
        take = min(S, C)
        src_pos = torch.arange(S - take, S, device=dev)
        slots = src_pos % C
        ck[:, slots] = k[:, S - take:]
        cv[:, slots] = v[:, S - take:]
        kpos[:, slots] = src_pos[None].expand(B, take).to(torch.int32)
        if cfg.kv_cache_quant:
            ckq, ks = attn_mod.quant_rows(ck)
            cvq, vs = attn_mod.quant_rows(cv)
            return out, {"k": ckq, "v": cvq, "kscale": ks, "vscale": vs,
                         "kpos": kpos}
        return out, {"k": ck, "v": cv, "kpos": kpos}

    def unit_body(carry, up):
        h, a = carry
        caches = {}
        for i in range(cfg.unit_layers):
            lp = up[f"pos{i}"]
            if "mamba" in lp:
                h, c = prefill_layer(lp, h, None)
            else:
                h, c = prefill_layer(lp, h, _window_at(cfg, i))
                if "cross" in lp and enc_out is not None:
                    h = attn_mod.cross_attention(
                        lp["cross"], attn_spec(cfg, None, False), h, enc_out,
                        eps=cfg.norm_eps)
                if "moe" in lp:
                    h, aa = moe_mod.moe_block(lp["moe"], moe_spec(cfg), h,
                                              cfg.norm_eps)
                    a = a + aa
                else:
                    h = L.mlp(lp["mlp"], h, cfg.norm_eps)
            caches[f"pos{i}"] = c
        if shared is not None:
            h2, c = prefill_layer({"attn": shared["attn"]}, h, None)
            h = L.mlp(shared["mlp"], h2, cfg.norm_eps)
            caches["shared"] = c
        return (h, a), caches

    (x, aux), unit_caches = _scan_units(unit_body, (x, aux), params["units"],
                                        unroll=unroll)

    caches: dict[str, Any] = {"units": unit_caches}
    _, rem = _unit_count(cfg)
    if rem:
        rem_caches = []
        for i in range(rem):
            lp = _tree_at(params["rem"], i)["pos0"]
            x, c = prefill_layer(lp, x, _window_at(cfg, i))
            if "moe" in lp:
                x, aa = moe_mod.moe_block(lp["moe"], moe_spec(cfg), x,
                                          cfg.norm_eps)
                aux = aux + aa
            elif "mamba" not in lp:
                x = L.mlp(lp["mlp"], x, cfg.norm_eps)
            rem_caches.append({"pos0": c})
        caches["rem"] = _stack(rem_caches)
    if enc_out is not None:
        caches["enc_out"] = enc_out

    return _logits(params, cfg, x[:, -1:]), caches


def flops_estimate(cfg: ModelConfig, batch: int, seq: int,
                   kind: str = "train") -> float:
    """Analytic model FLOPs (fwd; x3 for train fwd+bwd), as the reference
    counts them."""
    tokens = batch * seq
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.family in ("ssm", "hybrid"):
            total += ssm_mod.mamba_flops(mamba_spec(cfg), tokens)
        else:
            s = attn_spec(cfg, _window_at(cfg, i))
            total += attn_mod.attn_flops(s, tokens, seq)
            if cfg.moe:
                total += moe_mod.moe_flops(moe_spec(cfg), tokens)
            else:
                total += L.mlp_flops(cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                     tokens)
    if cfg.family == "hybrid":
        n_units = cfg.num_layers // cfg.hybrid_unit
        s = attn_spec(cfg, None)
        total += n_units * (attn_mod.attn_flops(s, tokens, seq)
                            + L.mlp_flops(cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                          tokens))
    if cfg.encoder_layers:
        etok = batch * cfg.num_prefix_embeds
        s = attn_spec(cfg, None)
        total += cfg.encoder_layers * (
            attn_mod.attn_flops(s, etok, cfg.num_prefix_embeds)
            + L.mlp_flops(cfg.d_model, cfg.d_ff, cfg.gated_mlp, etok))
        total += cfg.num_layers * attn_mod.attn_flops(s, tokens,
                                                      cfg.num_prefix_embeds)
    total += 2.0 * tokens * cfg.d_model * cfg.vocab   # unembed
    if kind == "train":
        total *= 3.0
    return total
