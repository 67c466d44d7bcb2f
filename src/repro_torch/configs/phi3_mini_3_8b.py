"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32064,
    gated_mlp=True,
    rope_theta=10_000.0,
    tie_embeddings=False,
    source="arXiv:2404.14219",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
