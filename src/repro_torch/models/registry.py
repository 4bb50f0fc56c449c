"""Model registry: family name -> module implementing the model API.

Port of ``repro/models/registry.py`` for the families the port has: the
dense and MoE decoders, the hubert encoder and the internvl VLM are
``models/transformer.py``, the rwkv6 recurrent LM ``models/rwkv6.py``. Each
module provides the reference's contract — ``forward``, ``loss_fn``,
``cache_specs``, ``layer_cache_kinds``, ``prefill``, ``prefill_chunk``
(with ``all_logits`` / ``collect_kv``) and ``decode_step`` (with
``active``). The reference's recurrentgemma raises ``NotImplementedError``
naming the family and ROADMAP module item 5b; an unknown name raises
``ValueError`` as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import FAMILIES, ModelConfig

from . import rwkv6, transformer

_FAMILIES = {**dict.fromkeys(FAMILIES, transformer), "rwkv6": rwkv6}
_UNPORTED = ("recurrentgemma",)


def get_model(cfg: ModelConfig):
    """The module serving and training ``cfg.family``."""
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP module "
            f"item 5b); the port has {sorted(_FAMILIES)}")
    raise ValueError(f"unknown model family {cfg.family!r}")
