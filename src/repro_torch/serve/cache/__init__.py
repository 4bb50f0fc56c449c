"""serve/cache: the per-layer cache protocol and its backends (DESIGN.md §12).

``make_cache`` is the engine's one entry point: it reads the model's
per-layer cache kinds (``layer_cache_kinds``, the registry contract) and
builds the backend whose state covers them — the ring-paged KV cache for
``paged_kv`` / ``kv`` layers, the recurrent state for ``wkv``. The engine
never names a backend.
"""
from __future__ import annotations

from .paged import RingPagedKVCache
from .protocol import CacheBackend, StateCache
from .recurrent import RecurrentStateCache

__all__ = ["CacheBackend", "RecurrentStateCache", "RingPagedKVCache",
           "StateCache", "make_cache"]

# layer kind -> backend; every kind a model declares must land in one
# backend (the reference's window backend, for recurrentgemma's
# local / rglru layers, is not ported)
_PAGED_KINDS = frozenset({"paged_kv", "kv"})
_RECURRENT_KINDS = frozenset({"wkv"})
_WINDOW_KINDS = frozenset({"window", "rglru"})


def make_cache(cfg, model, slots: int, max_len: int, *,
               device=None) -> CacheBackend:
    """Build the cache backend serving ``model``'s per-layer kinds on
    ``device`` (default: cuda)."""
    kinds = tuple(model.layer_cache_kinds(cfg))
    ks = set(kinds)
    if ks <= _PAGED_KINDS:
        cache = RingPagedKVCache(cfg, slots, max_len, device=device)
    elif ks <= _RECURRENT_KINDS:
        cache = RecurrentStateCache(cfg, model, slots, max_len, device=device)
    elif ks <= _WINDOW_KINDS:
        raise NotImplementedError(
            f"layer cache kinds {sorted(ks)} need the sliding-window cache "
            "of the recurrentgemma family (ROADMAP module item 5b)")
    else:
        raise ValueError(
            f"no cache backend serves layer cache kinds {sorted(ks)} "
            f"(family {cfg.family!r})")
    cache.kinds = kinds
    return cache
