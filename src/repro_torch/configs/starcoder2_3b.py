"""starcoder2-3b [dense] — GQA kv=2, RoPE, classic MLP. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    gated_mlp=False,
    rope_theta=1e5,
    tie_embeddings=True,
    source="arXiv:2402.19173",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
