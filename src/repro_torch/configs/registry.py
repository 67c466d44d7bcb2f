"""Architecture registry: ``--arch <id>`` -> config module.

Every assigned architecture (plus the paper's own CNNs, which live in
``repro_torch.models.cnn`` as layer graphs) is selectable by its public id.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

ARCHS: dict[str, str] = {
    "pixtral-12b": "pixtral_12b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "starcoder2-3b": "starcoder2_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "gemma3-4b": "gemma3_4b",
    "granite-34b": "granite_34b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-2.7b": "mamba2_2_7b",
}

# long_500k runs only for sub-quadratic decode (DESIGN.md §Arch-applicability)
LONG_CONTEXT_OK = {"mamba2-2.7b", "zamba2-2.7b", "gemma3-4b"}


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke_config()


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def pair_supported(arch: str, shape: str) -> tuple[bool, str]:
    """Is (arch, shape) runnable?  Returns (ok, reason-if-skip)."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, ("SKIP(design): full-attention decode over 524k KV "
                       "(no assigned sub-quadratic variant)"
                       if arch != "seamless-m4t-large-v2"
                       else "SKIP(design): enc-dec, source-bounded decode")
    return True, ""


def all_pairs() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in INPUT_SHAPES]
