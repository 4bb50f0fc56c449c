"""Model registry: family name -> module implementing the model API.

Port of ``repro/models/registry.py``: the dense and MoE decoders, the
hubert encoder and the internvl VLM are ``models/transformer.py``, the
rwkv6 recurrent LM ``models/rwkv6.py``, the recurrentgemma hybrid
``models/recurrentgemma.py``. Each module provides the reference's
contract — ``forward``, ``loss_fn``, ``cache_specs``,
``layer_cache_kinds``, ``prefill``, ``prefill_chunk`` (with
``all_logits`` / ``collect_kv``) and ``decode_step`` (with ``active``). An
unknown name raises ``ValueError`` as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import FAMILIES, ModelConfig

from . import recurrentgemma, rwkv6, transformer

_FAMILIES = {**dict.fromkeys(FAMILIES, transformer), "rwkv6": rwkv6,
             "recurrentgemma": recurrentgemma}


def get_model(cfg: ModelConfig):
    """The module serving and training ``cfg.family``."""
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    raise ValueError(f"unknown model family {cfg.family!r}")
