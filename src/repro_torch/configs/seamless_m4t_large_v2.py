"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal.

[arXiv:2308.11596].  Per assignment the conv/mel frontend is a stub:
``input_specs`` provides precomputed frame embeddings (B, frames, d_model)
as the encoder input; this config is the 24+24 enc-dec transformer backbone.
"""
from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,                 # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab=256206,
    gated_mlp=False,
    num_prefix_embeds=1024,        # audio frames fed to the encoder
    tie_embeddings=False,
    # §Perf HC1: 256206 % 16 != 0 replicates the f32 logits over the tensor
    # axis (269 GB/device temp).  Padding to a multiple of 128 shards them.
    vocab_pad_multiple=128,
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return reduced(CONFIG)
