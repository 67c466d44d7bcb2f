"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409].  Per assignment, the ViT/projector frontend
is a stub: ``input_specs`` provides precomputed patch embeddings of shape
(B, num_prefix_embeds, d_model); this config is the language decoder that
consumes them (early fusion — embeds replace the leading token positions).
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    gated_mlp=True,
    rope_theta=1e6,
    num_prefix_embeds=256,          # one 1024px image -> 256 patch embeddings
    tie_embeddings=False,
    source="hf:mistralai/Pixtral-12B-2409",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
