"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k.

[hf:google/gemma-3-1b-pt].  Repeating unit: 5 sliding-window (1024) layers,
then 1 global layer; 34 layers = 5 full units + 4 local remainder.
The sliding-window layers make long_500k decode sub-quadratic in cache size
(local layers cache only the window; global layers are single-token matvec).
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    gated_mlp=True,
    rope_theta=1e6,
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
