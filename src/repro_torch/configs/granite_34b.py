"""granite-34b [dense] — llama-arch code model, 88 layers, MQA (kv=1).

[arXiv:2405.04324].  GPT-BigCode-style classic (non-gated) MLP.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    gated_mlp=False,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="arXiv:2405.04324",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
