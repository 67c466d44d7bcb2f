"""Operations of a transformer with routed experts, window and full
attention layers and a held share of the experts, as the configuration
file gives it (Hugging Face ``config.json`` keys, ``num_experts`` held of
``num_experts_routed``)."""
from __future__ import annotations


def matmul_params(cfg: dict) -> float:
    """Weights that a token multiplies, on average: each layer's
    projections, its router, the held experts at their share of the top-k
    assignments (``num_experts_per_tok * num_experts /
    num_experts_routed`` experts of ``3 * hidden * moe_intermediate``),
    and the output head (the embedding is a gather)."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    attn = d * hd * (2 * cfg["num_attention_heads"]
                     + 2 * cfg["num_key_value_heads"])
    routed = cfg["num_experts_routed"]
    held = (cfg["num_experts_per_tok"] * cfg["num_experts"] / routed
            * 3 * d * cfg["moe_intermediate_size"])
    return len(cfg["layer_types"]) * (attn + d * routed + held) \
        + d * cfg["vocab_size"]


def attended(cfg: dict, kind: str, position: int) -> int:
    """Positions a token at ``position`` (0-based) attends in a layer of
    ``kind``: itself and every earlier one, at most the window's on a
    sliding layer."""
    n = position + 1
    return min(n, cfg["sliding_window"]) if kind == "sliding_attention" \
        else n


def token_flops(cfg: dict, position: int) -> float:
    """Operations of one token at ``position``: 2 per weight it multiplies
    (:func:`matmul_params`), and attention's 4 * heads * head_dim per
    position it attends in each layer."""
    per = 4.0 * cfg["num_attention_heads"] * cfg["head_dim"]
    return 2.0 * matmul_params(cfg) + per * sum(
        attended(cfg, k, position) for k in cfg["layer_types"])
