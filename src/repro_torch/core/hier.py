"""H-level pyramid: collapse-up hierarchy over evicted ring pages.

Port of ``repro/core/hier.py`` (DESIGN.md §14). The two-level decode path
keeps exact fine blocks in the ring plus one fp32 sum per page (the
pyramid). With ``levels = H >= 3`` a page that falls out of the fine window
is not dropped: its sums *collapse up* into coarser rings, so long history
stays reachable as background mass at geometrically coarsening resolution.

Level geometry (b = block_size, nb = fine pages):

  * level 0 — the fine ring: exact K/V tokens, ``nb`` pages of ``b``;
  * level 1 — the live pyramid: one fp32 K/V sum per fine page;
  * level ``l`` in ``[2, H)`` — a ring of ``n_l`` entries over evicted
    history; entry ``e`` aggregates fine blocks
    ``[e*2^(l-1), (e+1)*2^(l-1))``;
  * tail — one fp32 sum + count absorbing everything evicted past the top
    level, so no token mass is ever lost.

Collapse-up rule: evicted fine block ``g`` carries into level-2 entry
``g >> 1`` at slot ``(g >> 1) % n_2``; if that slot holds another owner,
the old entry cascades one level up (id halves again), and so on into the
tail — one slot touched per level. Batched evictions are applied
oldest-block-first, which keeps cascades identical to sequential decode.

Quantization: level 2 stores int8 means (qmax 127), levels >= 3 int4
precision in int8 containers (qmax 7), the tail fp32 sums. Sums are always
``mean * count``; dead entries (count 0) contribute exact zeros.

Cache layout (``models/transformer.cache_specs`` at H >= 3):

  * per layer (lists over layers): ``hier_k{l}``/``hier_v{l}`` int8
    (B, Hkv, n_l, D) means, ``hier_ks{l}``/``hier_vs{l}`` fp32 (B, Hkv, n_l)
    scales, ``tail_k``/``tail_v`` fp32 (B, Hkv, D) sums;
  * shared (like ``page_blocks``): ``hier_own{l}`` (B, n_l) int32 owner
    (-1 dead), ``hier_cnt{l}`` (B, n_l) int32 token counts, ``tail_cnt``
    (B,) int32.

The functions below return new tensors and leave their inputs alone, as
the reference's do; ``cache_store_layer`` and the model's table updates
copy the results into the cache tensors in place, so every per-layer
tensor must be its own (``build_hier_stream`` makes one per layer).
Attention consumes the stack through one ``HierUpper`` view: collapsed
entries are strictly older than every live query, so the fold needs no
causal mask — liveness (count > 0) is the only gate.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

_DEAD = 2**31 - 1  # sort sentinel: absent eviction slots


class HierUpper(NamedTuple):
    """Dequantized view of every collapsed level + the tail, concatenated.

    k_mean/v_mean: (B, Hkv, NU, D) fp32 per-entry mean key/value.
    counts: (B, NU) fp32 token count per entry (0 = dead entry).
    NU = sum(n_l for l in 2..H-1) + 1 (the tail).
    """

    k_mean: torch.Tensor
    v_mean: torch.Tensor
    counts: torch.Tensor


class LevelPlan(NamedTuple):
    """Value-independent collapse decisions at one level (all (B,))."""

    slot: torch.Tensor     # int32 physical slot touched at this level
    on: torch.Tensor       # bool: a carry lands at this level
    reset: torch.Tensor    # bool: slot content replaced (fresh claim or evict)
    old_cnt: torch.Tensor  # int32 slot count before the update
    new_cnt: torch.Tensor  # int32 slot count after the update


class CollapsePlan(NamedTuple):
    levels: tuple           # tuple[LevelPlan, ...] bottom-up
    tail_on: torch.Tensor   # (B,) bool: a carry reached the tail
    tail_cnt: torch.Tensor  # (B,) int32 token count folded into the tail


def level_qmax(level: int) -> float:
    """Quantization ceiling per level: int8 near (l=2), int4 far (l>=3)."""
    return 127.0 if level == 2 else 7.0


def hier_level_ids(cache) -> tuple:
    """Collapsed-level ids present in a cache mapping (sorted, () at H=2)."""
    pre = "hier_own"
    return tuple(sorted(int(k[len(pre):]) for k in cache if k.startswith(pre)))


def has_hier(cache) -> bool:
    return "tail_cnt" in cache


def quantize_mean(mean: torch.Tensor, qmax: float):
    """Per-entry symmetric quantization of a (…, D) mean -> (int8, scale).

    Round half to even (``torch.round``, as ``jnp.round``), scale
    ``max(amax, 1e-8) / qmax`` in that order.
    """
    m = mean.to(torch.float32)
    amax = m.abs().amax(-1)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(m / scale[..., None]), -qmax, qmax)
    return q.to(torch.int8), scale


def collapse_tables(owners: Sequence[torch.Tensor],
                    counts: Sequence[torch.Tensor], tail_cnt: torch.Tensor,
                    blk: torch.Tensor, child_cnt: torch.Tensor,
                    present: torch.Tensor):
    """Run the carry chain on the shared owner/count tables (value-free).

    Args:
      owners/counts: per-level (B, n_l) int32 tables, level 2 first.
      tail_cnt: (B,) int32.
      blk: (B,) evicted fine-block id (garbage where ``present`` is False).
      child_cnt: (B,) token count of the evicted block (``b`` in the ring).
      present: (B,) bool — whether this batch row evicts anything.

    Returns:
      (new_owners, new_counts, new_tail_cnt, CollapsePlan); the inputs are
      not modified.
    """
    b_idx = torch.arange(blk.shape[0], device=blk.device)
    # the where comes first: an absent row's -1 owner never shifts
    eid = torch.where(present, blk, 0).to(torch.int32) >> 1
    cc = child_cnt.to(torch.int32)
    on = present
    new_owners = [o.clone() for o in owners]
    new_counts = [c.clone() for c in counts]
    plans = []
    for li in range(len(new_owners)):
        n = new_owners[li].shape[1]
        slot = eid % n
        own = new_owners[li][b_idx, slot]
        oldc = new_counts[li][b_idx, slot]
        match = on & (own == eid)
        evict = on & ~match & (own >= 0)
        reset = on & ~match
        newc = torch.where(reset, 0, oldc) + torch.where(on, cc, 0)
        new_owners[li][b_idx, slot] = torch.where(on, eid, own)
        new_counts[li][b_idx, slot] = torch.where(on, newc, oldc)
        plans.append(LevelPlan(slot, on, reset, oldc, newc))
        eid = torch.where(evict, own, 0) >> 1
        cc = oldc
        on = evict
    new_tail = torch.where(on, tail_cnt + cc, tail_cnt)
    return new_owners, new_counts, new_tail, CollapsePlan(tuple(plans), on, cc)


def collapse_values(kq: Sequence[torch.Tensor], vq: Sequence[torch.Tensor],
                    ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                    tail_k: torch.Tensor, tail_v: torch.Tensor,
                    plan: CollapsePlan, child_k: torch.Tensor,
                    child_v: torch.Tensor,
                    qmaxs: Optional[Sequence[float]]):
    """Apply one collapse plan to one layer's payload tensors.

    kq/vq: per-level (B, Hkv, n_l, D) stored means (int8 or fp32);
    ks/vs: per-level (B, Hkv, n_l) scales; tail_k/tail_v: (B, Hkv, D) sums;
    child_k/child_v: (B, Hkv, D) fp32 *sums* of the evicted fine block.
    qmaxs: per-level quantization ceilings, or None to store exact fp32
    means with unit scales. Returns new tensors; rows whose plan is off
    keep their bits.
    """
    b_idx = torch.arange(child_k.shape[0], device=child_k.device)
    carry_k = child_k.to(torch.float32)
    carry_v = child_v.to(torch.float32)
    kq, vq, ks, vs = list(kq), list(vq), list(ks), list(vs)
    for li, p in enumerate(plan.levels):
        oldc = p.old_cnt.to(torch.float32)[:, None, None]
        newc = torch.clamp(p.new_cnt, min=1).to(torch.float32)[:, None, None]
        on3 = p.on[:, None, None]
        out_sums = []
        for store, scale, carry in ((kq, ks, carry_k), (vq, vs, carry_v)):
            old_q = store[li][b_idx, :, p.slot]  # (B, Hkv, D)
            old_s = scale[li][b_idx, :, p.slot]  # (B, Hkv)
            old_sum = old_q.to(torch.float32) * old_s[..., None] * oldc
            new_sum = (torch.where(p.reset[:, None, None], 0.0, old_sum)
                       + torch.where(on3, carry, 0.0))
            mean = new_sum / newc
            if qmaxs is None:
                q, s = mean.to(store[li].dtype), torch.ones_like(old_s)
            else:
                q, s = quantize_mean(mean, qmaxs[li])
                q = q.to(store[li].dtype)
            new_store, new_scale = store[li].clone(), scale[li].clone()
            new_store[b_idx, :, p.slot] = torch.where(on3, q, old_q)
            new_scale[b_idx, :, p.slot] = torch.where(p.on[:, None], s, old_s)
            store[li], scale[li] = new_store, new_scale
            out_sums.append(old_sum)
        carry_k, carry_v = out_sums
    t_on = plan.tail_on[:, None, None]
    tail_k = torch.where(t_on, tail_k + carry_k, tail_k)
    tail_v = torch.where(t_on, tail_v + carry_v, tail_v)
    return kq, vq, ks, vs, tail_k, tail_v


def upper_view(kq, vq, ks, vs, counts, tail_k, tail_v,
               tail_cnt) -> HierUpper:
    """Assemble the dequantized all-levels + tail view attention consumes."""
    km = [q.to(torch.float32) * s[..., None] for q, s in zip(kq, ks)]
    vm = [q.to(torch.float32) * s[..., None] for q, s in zip(vq, vs)]
    tden = torch.clamp(tail_cnt, min=1).to(torch.float32)[:, None, None, None]
    km.append(tail_k.to(torch.float32)[:, :, None] / tden)
    vm.append(tail_v.to(torch.float32)[:, :, None] / tden)
    cnt = [c.to(torch.float32) for c in counts]
    cnt.append(tail_cnt.to(torch.float32)[:, None])
    return HierUpper(torch.cat(km, dim=2), torch.cat(vm, dim=2),
                     torch.cat(cnt, dim=1))


def eviction_schedule(old_pb: torch.Tensor, fresh: torch.Tensor, rounds: int):
    """Order a batch of evictions oldest-first for sequential collapse.

    old_pb: (B, nb) pre-update page table; fresh: (B, nb) pages recycled by
    the incoming writes. Returns ``min(rounds, nb)`` pairs
    ``(blk (B,), on (B,))`` — the j-th oldest evicted owner per batch row
    (ascending block id keeps cascades identical to one-at-a-time decode).
    """
    vals = torch.where(fresh & (old_pb >= 0), old_pb, _DEAD)
    order = torch.sort(vals, dim=1).values
    return [(order[:, j], order[:, j] < _DEAD)
            for j in range(min(rounds, old_pb.shape[1]))]


# ---------------------------------------------------------------------------
# Cache-dict glue: models/transformer.py and serve/cache/paged.py drive the
# collapse through these, so the key layout lives in exactly one place.
# ---------------------------------------------------------------------------

def cache_collapse_tables(cache, blk, child_cnt, present):
    """collapse_tables over the shared ``hier_*``/``tail_cnt`` cache keys.

    Returns (updates dict, CollapsePlan); the cache is not modified.
    """
    lids = hier_level_ids(cache)
    no, nc, tc, plan = collapse_tables(
        [cache[f"hier_own{l}"] for l in lids],
        [cache[f"hier_cnt{l}"] for l in lids],
        cache["tail_cnt"], blk, child_cnt, present)
    upd = {"tail_cnt": tc}
    for j, l in enumerate(lids):
        upd[f"hier_own{l}"] = no[j]
        upd[f"hier_cnt{l}"] = nc[j]
    return upd, plan


def cache_store_tables(cache, upd) -> None:
    """Copy a cache_collapse_tables update into the shared tables in place."""
    for key, t in upd.items():
        cache[key].copy_(t)


def cache_collapse_layer(cache, i, plan, child_k, child_v, *, quantize=True):
    """collapse_values for layer ``i``'s payloads; a dict keyed by cache key."""
    lids = hier_level_ids(cache)
    qmaxs = tuple(level_qmax(l) for l in lids) if quantize else None
    kq, vq, ks, vs, tk, tv = collapse_values(
        [cache[f"hier_k{l}"][i] for l in lids],
        [cache[f"hier_v{l}"][i] for l in lids],
        [cache[f"hier_ks{l}"][i] for l in lids],
        [cache[f"hier_vs{l}"][i] for l in lids],
        cache["tail_k"][i], cache["tail_v"][i],
        plan, child_k, child_v, qmaxs)
    upd = {"tail_k": tk, "tail_v": tv}
    for j, l in enumerate(lids):
        upd[f"hier_k{l}"] = kq[j]
        upd[f"hier_v{l}"] = vq[j]
        upd[f"hier_ks{l}"] = ks[j]
        upd[f"hier_vs{l}"] = vs[j]
    return upd


def cache_store_layer(cache, i, upd) -> None:
    """Copy a cache_collapse_layer update into layer ``i``'s tensors in place."""
    for key, arr in upd.items():
        cache[key][i].copy_(arr)


def cache_upper_view(cache, i) -> Optional[HierUpper]:
    """The HierUpper view for layer ``i``, or None when the cache is H=2."""
    if not has_hier(cache):
        return None
    lids = hier_level_ids(cache)
    return upper_view(
        [cache[f"hier_k{l}"][i] for l in lids],
        [cache[f"hier_v{l}"][i] for l in lids],
        [cache[f"hier_ks{l}"][i] for l in lids],
        [cache[f"hier_vs{l}"][i] for l in lids],
        [cache[f"hier_cnt{l}"] for l in lids],
        cache["tail_k"][i], cache["tail_v"][i], cache["tail_cnt"])


def build_hier_stream(k: torch.Tensor, v: torch.Tensor, *, block: int,
                      nb: int, levels: int, hier_n: Optional[int] = None,
                      num_layers: int = 1, quantize: bool = True):
    """Reference builder: stream (B, Hkv, S, D) K/V through an H-level ring.

    Writes each fine block into an ``nb``-page ring in order, collapsing
    the evicted owner up the hierarchy exactly as decode would. Returns a
    dict shaped like the serve cache: ``k_cache``/``v_cache`` (the live
    window), ``page_blocks``, ``pyr_k``/``pyr_v`` (per-layer lists, every
    layer equal but each its own tensor), the ``hier_*``/``tail_*`` keys,
    and ``lengths``.
    """
    B, Hkv, S, D = k.shape
    if S % block:
        raise ValueError(f"S={S} must be a multiple of block={block}")
    n = hier_n or nb
    dev = k.device
    f32, i32 = torch.float32, torch.int32

    def per_layer(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for _ in range(num_layers)]

    cache = {
        "k_cache": torch.zeros((B, Hkv, nb * block, D), dtype=k.dtype,
                               device=dev),
        "v_cache": torch.zeros((B, Hkv, nb * block, D), dtype=v.dtype,
                               device=dev),
        "page_blocks": torch.full((B, nb), -1, dtype=i32, device=dev),
        "pyr_k": per_layer((B, Hkv, nb, D), f32),
        "pyr_v": per_layer((B, Hkv, nb, D), f32),
        "lengths": torch.full((B,), S, dtype=i32, device=dev),
    }
    if levels >= 3:
        pdtype = torch.int8 if quantize else f32
        for l in range(2, levels):
            cache[f"hier_k{l}"] = per_layer((B, Hkv, n, D), pdtype)
            cache[f"hier_v{l}"] = per_layer((B, Hkv, n, D), pdtype)
            cache[f"hier_ks{l}"] = per_layer((B, Hkv, n), f32)
            cache[f"hier_vs{l}"] = per_layer((B, Hkv, n), f32)
            cache[f"hier_own{l}"] = torch.full((B, n), -1, dtype=i32,
                                               device=dev)
            cache[f"hier_cnt{l}"] = torch.zeros((B, n), dtype=i32, device=dev)
        cache["tail_k"] = per_layer((B, Hkv, D), f32)
        cache["tail_v"] = per_layer((B, Hkv, D), f32)
        cache["tail_cnt"] = torch.zeros((B,), dtype=i32, device=dev)

    ones = torch.ones((B,), dtype=torch.bool, device=dev)
    child = torch.full((B,), block, dtype=i32, device=dev)
    for g in range(S // block):
        page = g % nb
        old_owner = cache["page_blocks"][:, page].clone()
        ksum = cache["pyr_k"][0][:, :, page].clone()
        vsum = cache["pyr_v"][0][:, :, page].clone()
        if levels >= 3:
            upd, plan = cache_collapse_tables(cache, old_owner, child,
                                              ones & (old_owner >= 0))
            cache_store_tables(cache, upd)
            for i in range(num_layers):
                cache_store_layer(cache, i, cache_collapse_layer(
                    cache, i, plan, ksum, vsum, quantize=quantize))
        kb = k[:, :, g * block:(g + 1) * block]
        vb = v[:, :, g * block:(g + 1) * block]
        sl = slice(page * block, (page + 1) * block)
        cache["k_cache"][:, :, sl] = kb
        cache["v_cache"][:, :, sl] = vb
        for i in range(num_layers):
            cache["pyr_k"][i][:, :, page] = kb.to(f32).sum(dim=2)
            cache["pyr_v"][i][:, :, page] = vb.to(f32).sum(dim=2)
        cache["page_blocks"][:, page] = g
    return cache
