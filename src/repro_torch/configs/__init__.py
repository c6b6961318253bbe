"""Architecture registry of the port: ``--arch <id>`` resolves here, as in
the reference."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, EncoderConfig, InputShape, ModelConfig,
                                      MoEConfig, SSMConfig, reduced)

_MODULES = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-7b": "qwen2_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-1.7b": "qwen3_1_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}
# the 10 assigned architectures, in the reference's order
ARCH_IDS = tuple(_MODULES)

# extra variants (selectable by name, outside ARCH_IDS), as in the reference
_MODULES["qwen2-7b-kv8"] = "qwen2_7b_kv8"
ALL_ARCHS = tuple(_MODULES)     # ARCH_IDS and the variants


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ALL_ARCHS", "ARCH_IDS", "INPUT_SHAPES", "EncoderConfig", "InputShape",
           "ModelConfig", "MoEConfig", "SSMConfig", "all_configs", "get_config", "reduced"]
