"""serve/cache: the cache protocol and the ring-paged KV backend."""
from __future__ import annotations

from .paged import RingPagedKVCache
from .protocol import CacheBackend

__all__ = ["CacheBackend", "RingPagedKVCache"]
