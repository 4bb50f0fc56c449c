"""Per-layer cache protocol: the engine-facing contract every backend meets.

Port of ``repro/serve/cache/protocol.py``. The engine plans chunks and
decode waves; the model functions own the cache tree's layout and
numerics. What the engine needs from the cache object is lifecycle +
introspection:

  tree           the dict of tensors handed to every model call
  specs          the TensorSpec tree that declared it
  capacity       per-slot token budget for admission control, or None
                 when prompts of any length may stream through (H >= 3)
  chunk_cap      optional ceiling on the engine's prefill chunk size
  paged          ring-paged MRA semantics (page table + pyramid)
  reset_slots    bit-exact per-slot reset on (re)admission
  lengths        (slots,) host view of per-slot stream lengths
  spec_snapshot  the speculative snapshot / rewind pair; only the
  spec_rewind    ring-paged MRA cache has one (the defaults raise)
"""
from __future__ import annotations

import numpy as np


class CacheBackend:
    """Base class carrying the protocol defaults (see module docstring)."""

    paged = False
    capacity: int | None = None
    chunk_cap: int | None = None

    def reset_slots(self, mask: np.ndarray) -> None:
        raise NotImplementedError

    @property
    def lengths(self) -> np.ndarray:
        return self.tree["lengths"].cpu().numpy()

    def occupancy(self) -> dict:
        """Uniform occupancy gauges: ``slots_active``, ``tokens_live``,
        ``pages_live`` and ``tokens_evicted``."""
        lengths = self.lengths
        return {
            "slots_active": float((lengths > 0).sum()),
            "tokens_live": float(lengths.sum()),
            "pages_live": 0.0,
            "tokens_evicted": 0.0,
        }

    # speculative decoding is a ring-paged feature (DESIGN.md §10/§12)
    def spec_snapshot(self, window: int):
        raise NotImplementedError(
            "speculative rounds need the ring-paged MRA cache "
            "(pyramid pages are the draft model)")

    def spec_rewind(self, snap, target_lengths, gate, chunk_kv=None):
        raise NotImplementedError(
            "speculative rounds need the ring-paged MRA cache "
            "(pyramid pages are the draft model)")
