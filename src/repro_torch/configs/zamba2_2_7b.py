"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

[arXiv:2411.15242].  54 Mamba2 layers in 9 units of 6; after each unit the
single SHARED (weight-tied) attention+MLP block runs.  ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    gated_mlp=True,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk=256),
    hybrid_unit=6,
    tie_embeddings=True,
    source="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
