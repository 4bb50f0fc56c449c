"""serve/cache: the per-layer cache protocol and its backends (DESIGN.md §12).

``make_cache`` is the engine's one entry point: it reads the model's
per-layer cache kinds (``layer_cache_kinds``, the registry contract) and
builds the backend whose state covers them — the ring-paged KV cache for
``paged_kv`` / ``kv`` layers, the recurrent state for ``wkv``, the hybrid
window ring + RG-LRU state for ``window`` / ``rglru``. The engine never
names a backend.
"""
from __future__ import annotations

from .paged import RingPagedKVCache
from .protocol import CacheBackend, StateCache
from .recurrent import RecurrentStateCache
from .window import HybridWindowCache

__all__ = ["CacheBackend", "HybridWindowCache", "RecurrentStateCache",
           "RingPagedKVCache", "StateCache", "make_cache"]

# layer kind -> backend; every kind a model declares must land in one
# backend
_PAGED_KINDS = frozenset({"paged_kv", "kv"})
_RECURRENT_KINDS = frozenset({"wkv"})
_WINDOW_KINDS = frozenset({"window", "rglru"})


def make_cache(cfg, model, slots: int, max_len: int, *,
               device=None, mesh=None) -> CacheBackend:
    """Build the cache backend serving ``model``'s per-layer kinds on
    ``device`` (default: cuda); under ``mesh`` the rank's blocks."""
    kinds = tuple(model.layer_cache_kinds(cfg))
    ks = set(kinds)
    if ks <= _PAGED_KINDS:
        cache = RingPagedKVCache(cfg, slots, max_len, device=device,
                                 mesh=mesh)
    elif ks <= _RECURRENT_KINDS:
        cache = RecurrentStateCache(cfg, model, slots, max_len, device=device,
                                    mesh=mesh)
    elif ks <= _WINDOW_KINDS:
        cache = HybridWindowCache(cfg, model, slots, max_len, device=device,
                                  mesh=mesh)
    else:
        raise ValueError(
            f"no cache backend serves layer cache kinds {sorted(ks)} "
            f"(family {cfg.family!r})")
    cache.kinds = kinds
    return cache
