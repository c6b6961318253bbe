"""Architecture registry of the port: only the archs the port runs."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, SSMConfig, reduced

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-1.3b": "mamba2_1_3b",
}
ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port runs {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").CONFIG


__all__ = ["ARCH_IDS", "ModelConfig", "SSMConfig", "get_config", "reduced"]
