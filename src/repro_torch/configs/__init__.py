"""Architecture registry of the port: the dense, MoE, hubert, internvl,
rwkv6 and recurrentgemma archs (every one of the reference's)."""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, MoESpec, ShapeCfg

_ARCH_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen2-7b": "qwen2_7b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-1.7b": "qwen3_1_7b",
    "yi-6b": "yi_6b",
    "hubert-xlarge": "hubert_xlarge",
    "internvl2-1b": "internvl2_1b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCHS = tuple(_ARCH_MODULES)

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "MoESpec", "ShapeCfg",
           "get_config", "get_smoke_config"]


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
