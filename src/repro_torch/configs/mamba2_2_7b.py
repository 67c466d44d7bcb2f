"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060].  64 Mamba2 layers, d_state=128, O(1) decode state,
so long_500k decode is exact and sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, reduced

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
    # §Perf HC1 spillover: 50280 % 16 != 0 -> same replicated-logit tax
    vocab_pad_multiple=128,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
