"""Architecture registry of the port: only the archs the port runs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, reduced

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "stablelm-1.6b": "stablelm_1_6b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-7b": "qwen2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
}
ARCH_IDS = tuple(_MODULES)

# extra variants (selectable by name, outside ARCH_IDS), as in the reference
_MODULES["qwen2-7b-kv8"] = "qwen2_7b_kv8"
ALL_ARCHS = tuple(_MODULES)     # ARCH_IDS and the variants


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").CONFIG


__all__ = ["ALL_ARCHS", "ARCH_IDS", "ModelConfig", "MoEConfig", "SSMConfig", "get_config",
           "reduced"]
