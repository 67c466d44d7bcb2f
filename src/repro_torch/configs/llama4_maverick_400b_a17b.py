"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E].  Assigned as the text MoE backbone.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    gated_mlp=True,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=128, top_k=1, capacity_factor=1.25),
    tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
