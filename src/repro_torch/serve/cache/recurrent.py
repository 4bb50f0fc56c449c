"""Recurrent-state cache backend (the rwkv6 family, layer kind ``wkv``).

Port of ``repro/serve/cache/recurrent.py``. Per slot the state does not
grow with the stream: one (H, dh, dh) wkv matrix and the token-shift
carries (the previous token's normed activations of the time-mix and
channel-mix branches) per layer, and a length counter. The tree layout is
``rwkv6.cache_specs``; chunked prefill advances it through ``wkv_chunked``
with the state carried in, and ``decode_step`` one token at a time under an
``active`` mask, so ragged continuous batching keeps frozen slots bit for
bit.

No admission capacity (``capacity = None``): prompts and generations of any
length fit in constant memory. Speculative decoding is unsupported: there
is no pyramid to draft from and no ring to rewind (DESIGN.md §12).
"""
from __future__ import annotations

from .protocol import StateCache

__all__ = ["RecurrentStateCache"]


class RecurrentStateCache(StateCache):
    """Fixed-size wkv state per slot; the lifecycle is StateCache's.

    Occupancy uses the protocol's defaults: the state absorbs history
    instead of paging it, so ``tokens_live`` is the whole absorbed stream
    and ``pages_live`` / ``tokens_evicted`` stay 0.
    """
