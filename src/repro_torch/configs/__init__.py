"""Architecture registry of the port: the dense archs served so far."""
from __future__ import annotations

import importlib

from .base import ModelConfig

_ARCH_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-1.7b": "qwen3_1_7b",
}

ARCHS = tuple(_ARCH_MODULES)

__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise ValueError(f"unknown arch {name!r}; ported: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    cfg = _module(name).smoke()
    return cfg.replace(**overrides) if overrides else cfg
