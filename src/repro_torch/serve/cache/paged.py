"""Ring-paged KV cache backend for the serving engine.

Port of ``repro/serve/cache/paged.py``. Physical pages are
``cfg.attention.block_size`` tokens — exactly the MRA pyramid's blocks —
with one (B, nb) int32 table of logical block owners shared by every layer,
plus per-layer k/v/pyramid tensors declared by ``transformer.cache_specs``.
Position ``p`` of a slot lives at physical index ``p % capacity``; past the
capacity, appending recycles the oldest background page. Non-MRA attention
kinds get the same storage without a page table (dense, hard capacity).

This module owns the lifecycle: building the cache on its device, bit-exact
per-slot reset on admission, occupancy introspection, and the speculative
snapshot/rewind (DESIGN.md §10). Before a draft round ``spec_snapshot``
copies what a W-token write window can change: the W physical K/V rows
(and int8 scales) from each slot's length on, the lengths, the page table
and the pyramid sums — copies, since the model functions update the cache in
place. ``spec_rewind`` then restores any per-slot target length in
[L0, L0 + W]: lengths and window rows at positions >= target come back from
the snapshot, page ownership opened by writes at positions >= target is
undone, and the pyramid is rebuilt as the snapshot plus the kept positions'
fp32 contributions (from the verify chunk's K/V, through the same one-hot
einsum as ``prefill_chunk``).

H-level hierarchy (``cfg.attention.levels >= 3``, ``core/hier.py``,
DESIGN.md §14): ring eviction becomes collapse-up — a recycled page's sums
merge into coarser per-level rings and an fp32 tail, so a slot serves
contexts far longer than its fine window from bounded memory.
``capacity`` is then None (prompts of any length stream through chunked
prefill), ``chunk_cap`` keeps every chunk one block short of the window
(so what a chunk collapses is older than all its queries),
``window_tokens`` stays the fine-window size, and ``occupancy()`` adds
per-level gauges. The snapshot then also copies the hierarchy, and the
rewind restores it whole before replaying, in ascending block order, the
collapses the kept writes performed.

Under a mesh (``mesh=``) the tree holds the rank's blocks
(``place_specs``: slots over the data axis, kv heads over "model"); the
engine-facing calls take and return every slot's values, and the engine
cuts each model call's per-slot inputs to the rank's rows (``rows``) and
gathers its logits over every slot (``whole``), so the scheduler and the
speculative rounds run unchanged on every rank.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import hier
from repro_torch.core.attention import MRA_KINDS
from repro_torch.distributed import collectives as C
from repro_torch.models import transformer
from repro_torch.models.params import materialize

from .protocol import CacheBackend

__all__ = ["RingPagedKVCache"]

_HIER_LAYER_KEYS = ("hier_k", "hier_v", "hier_ks", "hier_vs")


def place_specs(specs: dict, mesh) -> dict:
    """The cache specs of the rank's blocks on ``mesh``: every tensor placed
    by its axes (batch -> data, kv-heads -> model), the sequence axis kept
    whole (the reference's ``kv_seq`` data split, taken only when the slots
    do not divide the data axis, is not ported: the slots are then
    replicated over it)."""
    from repro_torch.distributed.sharding import (
        ShardingRules,
        local_shape,
        logical_to_pspec,
    )

    rules = ShardingRules().override(kv_seq=())

    def one(s):
        pspec = logical_to_pspec(s.shape, s.axes, mesh, rules)
        return s._replace(shape=local_shape(s.shape, pspec, mesh))

    return {k: [one(x) for x in v] if isinstance(v, list) else one(v)
            for k, v in specs.items()}


def _window_indices(lengths, W: int, S: int):
    """((B, W) global positions, (B, W) physical ring indices, (B, W) rows)."""
    B = lengths.shape[0]
    pos = lengths[:, None].long() + torch.arange(W, device=lengths.device)
    b2 = torch.arange(B, device=lengths.device)[:, None].expand(B, W)
    return pos, pos % S, b2


class RingPagedKVCache(CacheBackend):
    """Decode state: KV pages + pyramid + page table + lengths, on ``device``
    (default: cuda)."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int, *,
                 device=None, mesh=None):
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
        self.supports_spec = self.paged
        self.block = cfg.attention.block_size if self.paged else None
        self.pages = max_len // cfg.attention.block_size if self.paged else None
        self.quantized = "k_scale" in self.specs
        self.hier_lids = (tuple(range(2, cfg.attention.levels)) if self.paged
                          else ())
        self.window_tokens = max_len
        if self.hier_lids:
            self.capacity = None
            self.chunk_cap = max_len - self.block
        self.mesh = mesh
        if mesh is not None:  # the rank's blocks (see place_specs)
            self.specs = place_specs(self.specs, mesh)
            self.row_split = self.specs["lengths"].shape[0] != slots
        self.tree = {
            k: ([materialize(s, self.device) for s in v] if isinstance(v, list)
                else materialize(v, self.device))
            for k, v in self.specs.items()}

    # ---- the rank's slots under a mesh ------------------------------------ #
    def rows(self, x):
        n = self.specs["lengths"].shape[0]
        if self.mesh is None or not self.row_split or x.shape[0] == n:
            return x
        i = self.mesh.index("data")
        return x[i * n:(i + 1) * n]

    def whole(self, t):
        if self.mesh is None or not self.row_split:
            return t
        return C.all_gather(t, self.mesh, "data", 0)

    @property
    def lengths(self) -> np.ndarray:
        return self.whole(self.tree["lengths"]).cpu().numpy()

    @torch.no_grad()
    def reset_slots(self, mask: np.ndarray) -> None:
        """Clear the slots selected by ``mask`` (B,) bool for re-admission.

        Only the validity state is cleared (lengths, page table, pyramid
        sums, and at H >= 3 the collapsed levels' owner/count tables and
        the tail); stale K/V bytes and collapsed payloads are unreachable
        once no live page or entry count points at them, so they stay — as
        in the reference.
        """
        m = torch.as_tensor(self.rows(np.asarray(mask, bool)),
                            device=self.device)
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

    # ---- speculative decoding: bounded ring snapshot / rewind -------------- #
    def _window_keys(self):
        return ("k", "v", "k_scale", "v_scale") if self.quantized else ("k", "v")

    @torch.no_grad()
    def spec_snapshot(self, window: int) -> dict:
        """Copy what a ``window``-token speculative round can change.

        The ``window`` physical K/V rows (and scales) from each slot's
        length on, gathered; the lengths, page table and pyramid sums (and
        at H >= 3 the hierarchy's tables, payloads and tail) cloned. Taken
        before the round's first write: the cache updates in place.
        """
        if not self.paged:
            return super().spec_snapshot(window)
        t = self.tree
        S = t["k"][0].shape[2]
        _, widx, b2 = _window_indices(t["lengths"], window, S)
        # every slot's lengths: the round adds every slot's counts to them
        snap = {"window": window, "lengths": self.whole(t["lengths"].clone()),
                "page_blocks": t["page_blocks"].clone(),
                "win": {key: [a[b2, :, widx] for a in t[key]]
                        for key in self._window_keys()}}
        for key in ("pyr_k", "pyr_v"):
            snap[key] = [a.clone() for a in t[key]]
        for lvl in self.hier_lids:
            for pre in ("hier_own", "hier_cnt"):
                snap[f"{pre}{lvl}"] = t[f"{pre}{lvl}"].clone()
            for pre in _HIER_LAYER_KEYS:
                snap[f"{pre}{lvl}"] = [a.clone() for a in t[f"{pre}{lvl}"]]
        if self.hier_lids:
            snap["tail_k"] = [a.clone() for a in t["tail_k"]]
            snap["tail_v"] = [a.clone() for a in t["tail_v"]]
            snap["tail_cnt"] = t["tail_cnt"].clone()
        return snap

    @torch.no_grad()
    def spec_rewind(self, snap: dict, target_lengths, gate,
                    chunk_kv=None) -> None:
        """Restore every ``gate`` slot to ``target_lengths`` in [L0, L0 + W].

        Slots with ``gate`` False, or already at their target, keep every
        byte. ``chunk_kv`` is the verify dispatch's (chunk_k, chunk_v)
        ((L, B, Hkv, C, D) fp32, C <= W), whose position-p entries re-enter
        the pyramid for L0 <= p < target; None replays nothing (the rewind
        after the drafts, target == L0).
        """
        t = self.tree
        dev = self.device
        W, block = snap["window"], self.block
        L0 = self.rows(snap["lengths"])
        Lt = self.rows(torch.as_tensor(target_lengths, device=dev)).to(
            L0.dtype)
        gate = self.rows(torch.as_tensor(gate, device=dev)).to(torch.bool)
        cur = t["lengths"]
        need = gate & (Lt < cur)
        S = t["k"][0].shape[2]
        pos, widx, b2 = _window_indices(L0, W, S)
        restore = need[:, None] & (pos >= Lt[:, None])  # (B, W)
        for key in self._window_keys():
            for a, saved in zip(t[key], snap["win"][key]):
                m = restore.reshape(restore.shape + (1,) * (saved.ndim - 2))
                a[b2, :, widx] = torch.where(m, saved, a[b2, :, widx])
        # page ownership opened by a write at position >= Lt is undone; an
        # owner whose block starts below Lt exists at Lt (at worst partial)
        pb = t["page_blocks"]
        undo = need[:, None] & (pb.long() * block >= Lt[:, None])
        pb.copy_(torch.where(undo, snap["page_blocks"], pb))
        # pyramid: snapshot + the kept window positions' fp32 contributions;
        # a page recycled by a kept write starts its new block from zero
        npages = pb.shape[1]
        page = (pos // block) % npages
        keep_tok = need[:, None] & (pos < Lt[:, None])
        ind_b = ((page[:, :, None] == torch.arange(npages, device=dev))
                 & keep_tok[:, :, None])
        ind = ind_b.to(torch.float32)
        fresh = (ind_b & ((pos % block) == 0)[:, :, None]).any(1)
        f4 = fresh[:, None, :, None]
        n4 = need[:, None, None, None]
        for li in range(len(t["pyr_k"])):
            for key, j in (("pyr_k", 0), ("pyr_v", 1)):
                base = torch.where(f4, 0.0, snap[key][li])
                if chunk_kv is not None:
                    ck = chunk_kv[j][li]  # (B, Hkv, C, D)
                    base = base + torch.einsum(
                        "bcy,bhcd->bhyd", ind[:, :ck.shape[2]], ck)
                t[key][li].copy_(torch.where(n4, base, t[key][li]))
        if self.hier_lids:
            self._rewind_hierarchy(snap, need, fresh, W)
        cur.copy_(torch.where(need, Lt, cur))

    def _rewind_hierarchy(self, snap, need, fresh, W: int) -> None:
        """H >= 3: restore the hierarchy of the ``need`` slots to the
        snapshot, then replay exactly the collapses the kept writes perform
        — the owners evicted from the pages the kept prefix recycled
        (``fresh``), with the snapshot's pyramid sums, oldest block first as
        sequential decode takes them — so the result equals never having
        speculated."""
        t = self.tree
        n2, n3 = need[:, None], need[:, None, None]
        n4 = need[:, None, None, None]
        for lvl in self.hier_lids:
            for pre in ("hier_own", "hier_cnt"):
                key = f"{pre}{lvl}"
                t[key].copy_(torch.where(n2, snap[key], t[key]))
            for pre, m in zip(_HIER_LAYER_KEYS, (n4, n4, n3, n3)):
                key = f"{pre}{lvl}"
                for a, saved in zip(t[key], snap[key]):
                    a.copy_(torch.where(m, saved, a))
        for key in ("tail_k", "tail_v"):
            for a, saved in zip(t[key], snap[key]):
                a.copy_(torch.where(n3, saved, a))
        t["tail_cnt"].copy_(torch.where(need, snap["tail_cnt"], t["tail_cnt"]))
        old_pb = snap["page_blocks"]
        B, npages = old_pb.shape
        b1 = torch.arange(B, device=old_pb.device)
        child = torch.full((B,), self.block, dtype=torch.int32,
                           device=old_pb.device)
        for blk_j, on_j in hier.eviction_schedule(old_pb, fresh,
                                                  W // self.block + 1):
            upd, plan = hier.cache_collapse_tables(t, blk_j, child, on_j)
            hier.cache_store_tables(t, upd)
            pg = blk_j % npages
            for li in range(len(t["pyr_k"])):
                hier.cache_store_layer(t, li, hier.cache_collapse_layer(
                    t, li, plan, snap["pyr_k"][li][b1, :, pg],
                    snap["pyr_v"][li][b1, :, pg]))

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
            cnt = self.whole(self.tree[f"hier_cnt{lvl}"]).cpu().numpy()
            occ[f"level{lvl}_entries"] = float((cnt > 0).sum())
            occ[f"level{lvl}_tokens"] = float(cnt.sum())
        if self.hier_lids:
            occ["tail_tokens"] = float(
                self.whole(self.tree["tail_cnt"]).cpu().numpy().sum())
        return occ

    def live_pages(self) -> Optional[np.ndarray]:
        """(B,) live (non-evicted) page count per slot; None when dense."""
        if not self.paged:
            return None
        return (self.whole(self.tree["page_blocks"]).cpu().numpy()
                >= 0).sum(-1)

    def window_start(self) -> np.ndarray:
        """(B,) oldest position still attendable (0 until eviction kicks in)."""
        if not self.paged:
            return np.zeros((self.slots,), np.int64)
        pb = self.whole(self.tree["page_blocks"]).cpu().numpy().astype(
            np.int64)
        oldest = np.where(pb >= 0, pb, np.iinfo(np.int64).max).min(-1)
        oldest = np.where((pb >= 0).any(-1), oldest, 0)
        return oldest * self.block
