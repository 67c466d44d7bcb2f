"""Model / run configuration system (the twin of ``repro.configs.base``,
kept as its own copy: the port imports nothing of the JAX package).

``ModelConfig`` is the single source of truth a model builder consumes.  One
file per assigned architecture lives next to this module; each exports
``CONFIG`` (the exact assigned full-size config, citation in ``source``) and
``smoke_config()`` (a reduced same-family variant for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # §Perf HC2: >1 = build per-data-shard capacity buffers so the dispatch
    # scatter stays shard-local (all-to-all of routed tokens instead of an
    # all-reduce of the full expert buffer over the data axis).
    token_shards: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int            # N (d_state)
    head_dim: int = 64        # P
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 256          # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int            # query heads (0 for attention-free)
    kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""

    head_dim: int | None = None          # default d_model // num_heads
    gated_mlp: bool = True               # SwiGLU (3 mats) vs classic (2 mats)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # sliding-window pattern: window size per layer-position within the
    # repeating unit; None = full attention.  gemma3: (1024,)*5 + (None,)
    window_pattern: tuple[int | None, ...] = (None,)

    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None

    # hybrid (zamba2-style): within a repeating unit of `unit` layers, the
    # last one is followed by the SHARED attention block
    hybrid_unit: int = 0                 # 0 = not hybrid

    # encoder-decoder (seamless-style)
    encoder_layers: int = 0              # 0 = decoder-only

    # multimodal stub frontends (per assignment: embeddings provided)
    num_prefix_embeds: int = 0           # image patches / audio frames per sample

    # training
    tie_embeddings: bool = True
    remat: bool = True
    remat_policy: str = "full"        # "full" | "dots" (save matmul outputs)

    # §Perf: pad the vocab so embedding/unembedding shard over the tensor
    # axis (a non-divisible vocab forces REPLICATED f32 logits — seamless'
    # 256206 cost 67 GB/device of logits alone).  0 = no padding.
    vocab_pad_multiple: int = 0

    # §Perf HC5: store KV caches as int8 + per-row f32 scale (the ZFP
    # fixed-rate idea applied to cache residency): ~2x less HBM held and
    # read per decoded token, bounded dequantization error.
    kv_cache_quant: bool = False

    def __post_init__(self):
        if self.num_heads:
            object.__setattr__(
                self, "head_dim", self.head_dim or self.d_model // self.num_heads
            )

    # ---- derived sizes -----------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_multiple:
            return self.vocab
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def unit_layers(self) -> int:
        """Length of the repeating (scannable) layer unit."""
        if self.hybrid_unit:
            return self.hybrid_unit
        return len(self.window_pattern) if len(self.window_pattern) > 1 else 1

    @property
    def attn_q_dim(self) -> int:
        return self.num_heads * (self.head_dim or 0)

    @property
    def attn_kv_dim(self) -> int:
        return self.kv_heads * (self.head_dim or 0)

    def param_count(self) -> int:
        """Analytic parameter count (matches the built model; tested)."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        total = self.padded_vocab * d                # embedding
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        dec_layers = L
        enc_layers = self.encoder_layers
        per_attn = d * self.attn_q_dim + 2 * d * self.attn_kv_dim \
            + self.attn_q_dim * d + d              # q,k,v,o + ln
        per_mlp = (3 if self.gated_mlp else 2) * d * f + d
        if self.moe:
            per_mlp = self.moe.num_experts * (3 if self.gated_mlp else 2) * d * f \
                + d * self.moe.num_experts + d       # experts + router + ln
        if self.family in ("ssm",):
            per_layer = self._mamba_params() + d
            total += dec_layers * per_layer
        elif self.family == "hybrid":
            n_units = dec_layers // self.hybrid_unit
            total += dec_layers * (self._mamba_params() + d)
            total += per_attn + per_mlp              # one SHARED attn block
            del n_units
        else:
            total += dec_layers * (per_attn + per_mlp)
            total += enc_layers * (per_attn + per_mlp)
            if enc_layers:                           # cross-attention in decoder
                total += dec_layers * per_attn
        total += d                                   # final norm
        return total

    def _mamba_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        s = self.ssm
        d_inner = s.expand * d
        n_heads = d_inner // s.head_dim
        n_groups = 1
        in_proj = d * (2 * d_inner + 2 * n_groups * s.state_dim + n_heads)
        ch = d_inner + 2 * n_groups * s.state_dim
        conv = s.conv_width * ch + ch                # depthwise weight + bias
        out_proj = d_inner * d
        extras = 3 * n_heads + d_inner               # A_log, dt_bias, D + norm
        return in_proj + conv + out_proj + extras

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.gated_mlp else 2) * d * f
        inactive = self.num_layers * (self.moe.num_experts - self.moe.top_k) * per_expert
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: 2 layers, d_model<=512, <=4 experts, same family."""
    small: dict = dict(
        num_layers=2,
        d_model=256,
        num_heads=4,
        kv_heads=min(cfg.kv_heads, 4) if cfg.kv_heads else 0,
        d_ff=512 if cfg.d_ff else 0,
        vocab=512,
        head_dim=64 if cfg.num_heads else None,
    )
    if cfg.moe:
        small["moe"] = MoEConfig(num_experts=4, top_k=min(cfg.moe.top_k, 2),
                                 capacity_factor=2.0)
    if cfg.ssm:
        small["ssm"] = SSMConfig(state_dim=16, head_dim=32, expand=2, chunk=32)
    if cfg.hybrid_unit:
        small["hybrid_unit"] = 2
        small["num_layers"] = 4
    if cfg.encoder_layers:
        small["encoder_layers"] = 2
    if cfg.num_prefix_embeds:
        small["num_prefix_embeds"] = 8
    if len(cfg.window_pattern) > 1:
        small["window_pattern"] = (32, None)
        small["num_layers"] = 2
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
