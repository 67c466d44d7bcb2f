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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import (LayerDecode, LayerGraph, TensorSpec,
                                    tree_leaves, tree_map)
from repro_torch.models.attention import (AttnSpec, attention,
                                          attention_decode, attn_flops)
from repro_torch.models.layers import (apply_rope, linear, mlp, mlp_flops,
                                       rmsnorm)

# rows every decode step computes (sessions of one wave, padded by
# repeating the last; more sessions take several steps of this size)
DECODE_STEP_ROWS = 8


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def _attn_nodes(spec: AttnSpec, cache_len: int, use_kernel: bool):
    """(fn, prefill, step) closures for one attention block."""

    def fn(p, x):
        return attention(p, spec, x, _positions(x))

    def prefill(p, x):
        B, S, _ = x.shape
        positions = _positions(x)
        y = attention(p, spec, x, positions)
        # cache the prompt's K/V at slots [0, S) of the fixed-capacity
        # buffer (prompts longer than cache_len are rejected at session
        # open); kpos = -1 marks empty slots for the decode mask
        h = rmsnorm(p["ln"], x)
        k = linear(p["wk"], h).reshape(B, S, spec.kv_heads, spec.head_dim)
        v = linear(p["wv"], h).reshape(B, S, spec.kv_heads, spec.head_dim)
        k = apply_rope(k, positions, spec.rope_theta)
        shape = (B, cache_len, spec.kv_heads, spec.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
        ck[:, :S] = k
        cv[:, :S] = v
        kpos = torch.full((B, cache_len), -1, dtype=torch.int32,
                          device=x.device)
        kpos[:, :S] = torch.arange(S, dtype=torch.int32, device=x.device)
        return y, {"k": ck, "v": cv, "kpos": kpos}

    def step(p, cache, x, pos):
        # updates the cache's tensors in place (see attention_decode)
        out, kv, kpos = attention_decode(
            p, spec, x, pos, {"k": cache["k"], "v": cache["v"]},
            cache["kpos"], use_kernel=use_kernel)
        return out, {"k": kv["k"], "v": kv["v"], "kpos": kpos}

    return fn, prefill, step


def _embed(p, x):
    return p["table"][x.long()]


def _head(p, x):
    return linear(p["out"], rmsnorm(p["ln"], x))


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

