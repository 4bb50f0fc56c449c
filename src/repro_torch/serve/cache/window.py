"""Hybrid sliding-window + recurrent cache backend (recurrentgemma family).

Port of ``repro/serve/cache/window.py``. One tree, two per-layer kinds
(DESIGN.md §12): the ``window`` layers hold a W-entry K/V ring keyed by
absolute positions (``kv_pos``, -1 = empty; W = min(cfg.local_window,
max_len)), and the ``rglru`` layers hold the RG-LRU hidden state plus the
depthwise-conv tail. The layout is ``recurrentgemma.cache_specs``; the
model's ``prefill_chunk`` / ``decode_step`` pick each layer's leaves over
its block pattern, so the engine has no special case for the family.

Like the recurrent backend the per-slot state is bounded (O(window)), so
there is no admission capacity; unlike the paged backend the ring keyed by
position needs ``chunk_cap = W``: a prefill chunk longer than the window
would put two tokens into one ring entry in one dispatch (and the chunk's
own queries would lose keys they still attend). The engine clamps its
chunk size to it.
"""
from __future__ import annotations

import numpy as np

from .protocol import StateCache

__all__ = ["HybridWindowCache"]


class HybridWindowCache(StateCache):
    """Window ring + RG-LRU state per slot; chunk size capped at the window."""

    def __init__(self, cfg, model, slots: int, max_len: int, *, device=None,
                 mesh=None):
        super().__init__(cfg, model, slots, max_len, device=device, mesh=mesh)
        self.chunk_cap = min(cfg.local_window, max_len)

    def occupancy(self) -> dict:
        """Occupancy gauges (DESIGN.md §13): the ring holds the last
        ``W = chunk_cap`` tokens a slot, so ring entries = min(L, W) and
        positions older than the window count as evicted (the RG-LRU state
        still carries them, but the local layers cannot see them)."""
        lengths = self.lengths
        held = np.minimum(lengths, self.chunk_cap)
        return {
            "slots_active": float((lengths > 0).sum()),
            "tokens_live": float(held.sum()),
            "pages_live": float(held.sum()),
            "tokens_evicted": float(np.maximum(lengths - self.chunk_cap,
                                               0).sum()),
        }
