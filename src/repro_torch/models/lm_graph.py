"""A decode-capable transformer as a partitionable :class:`LayerGraph` (the
twin of ``repro.models.lm_graph``).

This is the bridge between the attention/MLP primitives and the serving
runtime's autoregressive session path: every attention block carries a
:class:`~repro_torch.core.graph.LayerDecode` (prefill builds the
fixed-capacity KV cache, step consumes one token against it), every other
block is stateless token-wise compute whose ``fn`` already works at
``S=1``.  The graph is a pure chain, so any contiguous partition has
exactly one boundary activation — a decode step ships ``[1, 1, d_model]``
per hop instead of the full sequence.

Greedy decode through the distributed chain is bit-identical to
:func:`pipeline_decode_reference` because both run the very same
``prefill_fn``/``step_fn`` per layer AND at the same shapes: a step always
computes ``decode_step_rows`` rows, padded by repeating a row.  The
reference relies on XLA computing each row of a batch alike at any batch
size; PyTorch's CPU GEMM does not (a [1, d] @ [d, f] product and row 0
of an [8, d] one differ in the last bits), and cuBLAS may pick another
kernel for another M.  At a fixed M, a row's arithmetic does not depend on
which or how many sessions share the step.

:func:`decode_moe_lm_graph` builds the same chain with window and full
attention layers (a window layer's cache a ring of its window), YaRN, and
routed experts of which the graph holds a share.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.graph import (LayerDecode, LayerGraph, TensorSpec,
                                    tree_leaves, tree_map)
from repro_torch.models.attention import (AttnSpec, attention_decode,
                                          attention_kv, attn_flops)
from repro_torch.models.layers import Yarn, linear, mlp, mlp_flops, rmsnorm
from repro_torch.models.moe import (held_experts, held_experts_flops,
                                    held_experts_step)

# rows every decode step computes (sessions of one wave, padded by
# repeating the last; more sessions take several steps of this size)
DECODE_STEP_ROWS = 8


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def _attn_nodes(spec: AttnSpec, cache_len: int, use_kernel: bool,
                eps: float = 1e-5):
    """(fn, prefill, step) closures for one attention block whose cache
    holds ``cache_len`` slots (a window layer's ring: its window)."""

    def fn(p, x):
        return attention_kv(p, spec, x, _positions(x), eps)[0]

    def prefill(p, x):
        B, S, _ = x.shape
        y, k, v = attention_kv(p, spec, x, _positions(x), eps)
        # the prompt's last cache_len positions at slot pos % cache_len
        # (slots [0, S) where it fits; a window layer's ring wraps, as its
        # steps write it); prompts longer than a full layer's cache_len
        # are rejected at session open; kpos = -1 marks empty slots for
        # the decode mask
        shape = (B, cache_len, spec.kv_heads, spec.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
        kpos = torch.full((B, cache_len), -1, dtype=torch.int32,
                          device=x.device)
        lo = max(S - cache_len, 0)
        kept = torch.arange(lo, S, dtype=torch.int32, device=x.device)
        slots = slice(0, S) if lo == 0 else (kept % cache_len).long()
        ck[:, slots] = k[:, lo:]
        cv[:, slots] = v[:, lo:]
        kpos[:, slots] = kept
        return y, {"k": ck, "v": cv, "kpos": kpos}

    def step(p, cache, x, pos):
        # updates the cache's tensors in place (see attention_decode)
        out, kv, kpos = attention_decode(
            p, spec, x, pos, {"k": cache["k"], "v": cache["v"]},
            cache["kpos"], eps=eps, use_kernel=use_kernel)
        return out, {"k": kv["k"], "v": kv["v"], "kpos": kpos}

    return fn, prefill, step


def _embed(p, x):
    return p["table"][x.long()]


def _head(p, x, eps: float = 1e-5):
    return linear(p["out"], rmsnorm(p["ln"], x, eps))


def decode_lm_graph(vocab: int = 64, d_model: int = 32, n_layers: int = 2,
                    num_heads: int = 2, kv_heads: int = 2, head_dim: int = 16,
                    d_ff: int = 64, cache_len: int = 64, seq_hint: int = 8,
                    use_kernel: bool = False, dtype=np.float32) -> LayerGraph:
    """Build a decoder-only transformer LayerGraph (RMSNorm, RoPE θ=1e4,
    ungated tanh-GELU MLP, untied head).

    ``cache_len`` is the per-session KV capacity every attention block
    allocates at prefill — a graph-level constant so per-session caches
    (leading axis 1) stack into one decode batch.  ``seq_hint`` only sizes
    the nominal out_specs the partitioner costs cuts with.  ``use_kernel``
    runs decode attention through the port's CUDA kernel (its plain
    version for CPU tensors).
    """
    spec = AttnSpec(d_model=d_model, num_heads=num_heads, kv_heads=kv_heads,
                    head_dim=head_dim)
    f32 = np.dtype(dtype)
    g = LayerGraph(f"lm-{n_layers}x{d_model}",
                   TensorSpec((1, seq_hint), np.int32))
    act_spec = TensorSpec((1, seq_hint, d_model), f32)

    def sds(*shape):
        return TensorSpec(shape, f32)

    g.layer("embed", _embed, {"table": sds(vocab, d_model)},
            ("",), act_spec, flops=0.0, pad_safe=True)
    prev = "embed"
    for i in range(n_layers):
        fn, prefill, step = _attn_nodes(spec, cache_len, use_kernel)
        g.layer(f"blk{i}_attn", fn,
                {"ln": {"scale": sds(d_model)},
                 "wq": {"w": sds(d_model, num_heads * head_dim)},
                 "wk": {"w": sds(d_model, kv_heads * head_dim)},
                 "wv": {"w": sds(d_model, kv_heads * head_dim)},
                 "wo": {"w": sds(num_heads * head_dim, d_model)}},
                (prev,), act_spec,
                flops=attn_flops(spec, seq_hint, seq_hint),
                pad_safe=False,
                decode=LayerDecode(prefill_fn=prefill, step_fn=step))
        g.layer(f"blk{i}_mlp", mlp,
                {"ln": {"scale": sds(d_model)},
                 "up": {"w": sds(d_model, d_ff)},
                 "down": {"w": sds(d_ff, d_model)}},
                (f"blk{i}_attn",), act_spec,
                flops=mlp_flops(d_model, d_ff, False, seq_hint),
                pad_safe=True)
        prev = f"blk{i}_mlp"
    g.layer("head", _head,
            {"ln": {"scale": sds(d_model)},
             "out": {"w": sds(d_model, vocab)}},
            (prev,), TensorSpec((1, seq_hint, vocab), f32),
            flops=2.0 * seq_hint * d_model * vocab, pad_safe=True)
    # per-session KV capacity; the session layer enforces
    # len(prompt) + max_new_tokens <= decode_cache_len at open
    g.decode_cache_len = cache_len
    g.decode_step_rows = DECODE_STEP_ROWS
    return g


def _rope(rope: dict) -> tuple[float, Yarn | None]:
    """(theta, YaRN or None) of one section of a config's
    ``rope_parameters``."""
    if rope.get("rope_type", "default") == "default":
        return float(rope["rope_theta"]), None
    if rope["rope_type"] != "yarn":
        raise ValueError(f"rope_type {rope['rope_type']!r}: default or yarn")
    return float(rope["rope_theta"]), Yarn(
        float(rope["factor"]), int(rope["original_max_position_embeddings"]),
        float(rope.get("beta_fast", 32)), float(rope.get("beta_slow", 1)),
        float(rope.get("attention_factor", 1.0)))


def decode_moe_lm_graph(
        vocab: int = 64, d_model: int = 32,
        layer_types: Sequence[str] = ("sliding_attention",) * 3
        + ("full_attention",),
        num_heads: int = 4, kv_heads: int = 2, head_dim: int = 8,
        sliding_window: int = 8, rope_parameters: dict | None = None,
        expert_d_ff: int = 16, num_experts: int = 8, top_k: int = 2,
        experts_held: tuple[int, int] = (0, 8), eps: float = 1e-6,
        cache_len: int = 64, seq_hint: int = 8, use_kernel: bool = False,
        dtype=np.float32) -> LayerGraph:
    """Build a decoder-only transformer with routed experts as a LayerGraph
    (RMSNorm at ``eps``, an untied head).

    Layer i attends as ``layer_types[i]`` says: ``full_attention`` over a
    ``cache_len``-slot cache, ``sliding_attention`` over the last
    ``sliding_window`` positions (p - k < window) in a ring of that many
    slots.  Each kind takes its RoPE from ``rope_parameters[kind]``
    (``rope_theta``; ``rope_type`` default or yarn, as Hugging Face
    transformers reads it).  Every MLP is ``num_experts`` SwiGLU experts
    of width ``expert_d_ff`` routed top-``top_k`` (softmax, renormalised
    over the k), of which experts ``[first, first + count)``
    (``experts_held``) are held and computed: one chip's share of an
    expert-parallel deployment, the router keeping every output.

    The session capacity (``decode_cache_len``) is the full layers':
    rings never fill.  ``use_kernel`` runs decode attention through the
    port's CUDA kernel (its plain version for CPU tensors).
    """
    rope_parameters = rope_parameters or {
        "sliding_attention": {"rope_type": "default", "rope_theta": 1e4},
        "full_attention": {"rope_type": "default", "rope_theta": 1e4}}
    first, held = experts_held
    f32 = np.dtype(dtype)
    g = LayerGraph(f"moe-lm-{len(layer_types)}x{d_model}",
                   TensorSpec((1, seq_hint), np.int32))
    act_spec = TensorSpec((1, seq_hint, d_model), f32)

    def sds(*shape):
        return TensorSpec(shape, f32)

    g.layer("embed", _embed, {"table": sds(vocab, d_model)},
            ("",), act_spec, flops=0.0, pad_safe=True)
    prev = "embed"
    for i, kind in enumerate(layer_types):
        if kind not in ("sliding_attention", "full_attention"):
            raise ValueError(f"layer {i}: unknown layer type {kind!r}")
        window = sliding_window if kind == "sliding_attention" else None
        theta, yarn = _rope(rope_parameters[kind])
        spec = AttnSpec(d_model=d_model, num_heads=num_heads,
                        kv_heads=kv_heads, head_dim=head_dim,
                        rope_theta=theta, window=window, yarn=yarn)
        slots = min(window, cache_len) if window else cache_len
        fn, prefill, step = _attn_nodes(spec, slots, use_kernel, eps)
        g.layer(f"blk{i}_attn", fn,
                {"ln": {"scale": sds(d_model)},
                 "wq": {"w": sds(d_model, num_heads * head_dim)},
                 "wk": {"w": sds(d_model, kv_heads * head_dim)},
                 "wv": {"w": sds(d_model, kv_heads * head_dim)},
                 "wo": {"w": sds(num_heads * head_dim, d_model)}},
                (prev,), act_spec,
                flops=attn_flops(spec, seq_hint, seq_hint),
                pad_safe=False,
                decode=LayerDecode(prefill_fn=prefill, step_fn=step))
        name = f"blk{i}_mlp"
        fn, prefill, step = _expert_nodes(top_k, first, name, eps)
        g.layer(name, fn,
                {"ln": {"scale": sds(d_model)},
                 "router": sds(d_model, num_experts),
                 "gate": sds(held, d_model, expert_d_ff),
                 "up": sds(held, d_model, expert_d_ff),
                 "down": sds(held, expert_d_ff, d_model)},
                (f"blk{i}_attn",), act_spec,
                flops=held_experts_flops(d_model, expert_d_ff, top_k,
                                         num_experts, held, seq_hint),
                pad_safe=True,
                decode=LayerDecode(prefill_fn=prefill, step_fn=step))
        prev = name
    g.layer("head", lambda p, x: _head(p, x, eps),
            {"ln": {"scale": sds(d_model)},
             "out": {"w": sds(d_model, vocab)}},
            (prev,), TensorSpec((1, seq_hint, vocab), f32),
            flops=2.0 * seq_hint * d_model * vocab, pad_safe=True)
    full = "full_attention" in layer_types
    g.decode_cache_len = cache_len if full else None
    g.decode_step_rows = DECODE_STEP_ROWS
    return g


def _expert_nodes(top_k: int, first: int, name: str, eps: float):
    """(fn, prefill, step) closures for one routed-expert block: tokens
    gathered per held expert, but in a decode step, where every held
    expert runs over the step's rows (fixed shapes, no host sync)."""

    def fn(p, x):
        return held_experts(p, x, top_k, first, eps)

    def prefill(p, x):
        return fn(p, x), {}

    def step(p, cache, x, pos):
        return held_experts_step(p, x, top_k, first, name, eps), {}

    return fn, prefill, step


def pipeline_decode_reference(graph: LayerGraph, params, prompt,
                              max_new_tokens: int,
                              margins: list | None = None) -> list[int]:
    """Single-device greedy decode through a decode-capable LayerGraph —
    the reference the distributed session path must match bit-for-bit.
    Runs the same per-layer ``prefill_fn``/``step_fn`` the compute nodes
    run, at the same shapes (prefill at B=1, steps at ``decode_step_rows``
    rows), just without partitioning or a wire.

    ``params`` are prepared (:meth:`LayerGraph.prepare`); the decode runs on
    their device.  With ``margins`` given, the top-1 minus top-2 logit of
    every emitted token is appended to it."""
    dev = tree_leaves(params)[0].device
    rows = getattr(graph, "decode_step_rows", DECODE_STEP_ROWS)
    with torch.inference_mode():
        acts = torch.as_tensor(np.asarray(prompt, np.int32).reshape(1, -1),
                               device=dev)
        pos = acts.shape[1]
        caches: dict[str, object] = {}
        for node in graph.nodes:
            p = params[node.name]
            if node.decode is not None:
                acts, caches[node.name] = node.decode.prefill_fn(p, acts)
            else:
                acts = node.fn(p, acts)
        # every step runs at ``rows`` identical rows; row 0 is the session
        caches = tree_map(
            lambda t: t.repeat((rows,) + (1,) * (t.dim() - 1)), caches)
        toks: list[int] = []
        while True:
            logits = acts[0, -1].cpu().numpy()
            toks.append(int(np.argmax(logits)))
            if margins is not None:
                top2 = np.partition(logits, -2)[-2:]
                margins.append(float(top2[1] - top2[0]))
            if len(toks) >= max_new_tokens:
                return toks
            acts = torch.full((rows, 1), toks[-1], dtype=torch.int32,
                              device=dev)
            pv = torch.full((rows,), pos, dtype=torch.int32, device=dev)
            for node in graph.nodes:
                p = params[node.name]
                if node.decode is not None:
                    acts, caches[node.name] = node.decode.step_fn(
                        p, caches[node.name], acts, pv)
                else:
                    acts = node.fn(p, acts)
            pos += 1

