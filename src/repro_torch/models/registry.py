"""Model registry: family name -> module implementing the model API.

Port of ``repro/models/registry.py`` for the families the port has: the
dense and MoE decoders are both ``models/transformer.py``. Each module
provides the reference's contract — ``forward``, ``loss_fn``,
``cache_specs``, ``layer_cache_kinds``, ``prefill``, ``prefill_chunk``
(with ``all_logits`` / ``collect_kv``) and ``decode_step`` (with
``active``). The reference's other families (hubert, internvl, rwkv6,
recurrentgemma) raise ``NotImplementedError`` naming the family; an
unknown name raises ``ValueError`` as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from . import transformer

_FAMILIES = {"dense": transformer, "moe": transformer}
_UNPORTED = ("hubert", "internvl", "rwkv6", "recurrentgemma")


def get_model(cfg: ModelConfig):
    """The module serving and training ``cfg.family``."""
    if cfg.family in _FAMILIES:
        return _FAMILIES[cfg.family]
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP module "
            f"item 5); the port has {sorted(_FAMILIES)}")
    raise ValueError(f"unknown model family {cfg.family!r}")
