"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    gated_mlp=True,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25),
    tie_embeddings=False,
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
