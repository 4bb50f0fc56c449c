"""Ring-paged KV cache backend for the serving engine.

Port of ``repro/serve/cache/paged.py``. Physical pages are
``cfg.attention.block_size`` tokens — exactly the MRA pyramid's blocks —
with one (B, nb) int32 table of logical block owners shared by every layer,
plus per-layer k/v/pyramid tensors declared by ``transformer.cache_specs``.
Position ``p`` of a slot lives at physical index ``p % capacity``; past the
capacity, appending recycles the oldest background page. Non-MRA attention
kinds get the same storage without a page table (dense, hard capacity).

This module owns the lifecycle: building the cache on its device, bit-exact
per-slot reset on admission, and occupancy introspection. The speculative
snapshot/rewind comes with its slice.

H-level hierarchy (``cfg.attention.levels >= 3``, ``core/hier.py``,
DESIGN.md §14): ring eviction becomes collapse-up — a recycled page's sums
merge into coarser per-level rings and an fp32 tail, so a slot serves
contexts far longer than its fine window from bounded memory.
``capacity`` is then None (prompts of any length stream through chunked
prefill), ``chunk_cap`` keeps every chunk one block short of the window
(so what a chunk collapses is older than all its queries),
``window_tokens`` stays the fine-window size, and ``occupancy()`` adds
per-level gauges.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import MRA_KINDS
from repro_torch.models import transformer
from repro_torch.models.params import materialize

from .protocol import CacheBackend

__all__ = ["RingPagedKVCache"]


class RingPagedKVCache(CacheBackend):
    """Decode state: KV pages + pyramid + page table + lengths, on ``device``
    (default: cuda)."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, *,
                 device=None):
        if cfg.attention.kind in MRA_KINDS:
            if max_len % cfg.attention.block_size != 0:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of the MRA block "
                    f"size {cfg.attention.block_size} (pages are blocks)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = slots
        self.capacity = max_len
        self.specs = transformer.cache_specs(cfg, slots, max_len)
        self.paged = "page_blocks" in self.specs
        self.block = cfg.attention.block_size if self.paged else None
        self.pages = max_len // cfg.attention.block_size if self.paged else None
        self.hier_lids = (tuple(range(2, cfg.attention.levels)) if self.paged
                          else ())
        self.window_tokens = max_len
        if self.hier_lids:
            self.capacity = None
            self.chunk_cap = max_len - self.block
        self.tree = {
            k: ([materialize(s, self.device) for s in v] if isinstance(v, list)
                else materialize(v, self.device))
            for k, v in self.specs.items()}

    @torch.no_grad()
    def reset_slots(self, mask: np.ndarray) -> None:
        """Clear the slots selected by ``mask`` (B,) bool for re-admission.

        Only the validity state is cleared (lengths, page table, pyramid
        sums, and at H >= 3 the collapsed levels' owner/count tables and
        the tail); stale K/V bytes and collapsed payloads are unreachable
        once no live page or entry count points at them, so they stay — as
        in the reference.
        """
        m = torch.as_tensor(np.asarray(mask, bool), device=self.device)
        t = self.tree
        t["lengths"].masked_fill_(m, 0)
        if self.paged:
            t["page_blocks"].masked_fill_(m[:, None], -1)
            for key in ("pyr_k", "pyr_v"):
                for a in t[key]:
                    a.masked_fill_(m[:, None, None, None], 0.0)
        for lvl in self.hier_lids:
            t[f"hier_own{lvl}"].masked_fill_(m[:, None], -1)
            t[f"hier_cnt{lvl}"].masked_fill_(m[:, None], 0)
        if self.hier_lids:
            for key in ("tail_k", "tail_v"):
                for a in t[key]:
                    a.masked_fill_(m[:, None, None], 0.0)
            t["tail_cnt"].masked_fill_(m, 0)

    def occupancy(self) -> dict:
        """Occupancy gauges: live tokens/pages + evictions.

        ``tokens_live`` counts positions still attendable (the window from
        the oldest live page to the stream head), ``pages_live`` the
        non-evicted page-table entries, ``tokens_evicted`` the positions
        ring eviction has dropped. Dense storage never evicts. At H >= 3
        evicted tokens live on: ``level{l}_entries`` / ``level{l}_tokens``
        count the live entries of collapsed level l and the tokens they
        hold, ``tail_tokens`` those folded into the tail.
        """
        occ = super().occupancy()
        if self.paged:
            lengths = self.lengths
            start = self.window_start()
            occ["tokens_live"] = float((lengths - start).sum())
            occ["pages_live"] = float(self.live_pages().sum())
            occ["tokens_evicted"] = float(start.sum())
        for lvl in self.hier_lids:
            cnt = self.tree[f"hier_cnt{lvl}"].cpu().numpy()
            occ[f"level{lvl}_entries"] = float((cnt > 0).sum())
            occ[f"level{lvl}_tokens"] = float(cnt.sum())
        if self.hier_lids:
            occ["tail_tokens"] = float(self.tree["tail_cnt"].cpu().numpy().sum())
        return occ

    def live_pages(self) -> Optional[np.ndarray]:
        """(B,) live (non-evicted) page count per slot; None when dense."""
        if not self.paged:
            return None
        return (self.tree["page_blocks"].cpu().numpy() >= 0).sum(-1)

    def window_start(self) -> np.ndarray:
        """(B,) oldest position still attendable (0 until eviction kicks in)."""
        if not self.paged:
            return np.zeros((self.slots,), np.int64)
        pb = self.tree["page_blocks"].cpu().numpy().astype(np.int64)
        oldest = np.where(pb >= 0, pb, np.iinfo(np.int64).max).min(-1)
        oldest = np.where((pb >= 0).any(-1), oldest, 0)
        return oldest * self.block
