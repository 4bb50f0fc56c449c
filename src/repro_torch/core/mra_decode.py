"""MRA-2 attention for autoregressive decode and chunked prefill.

Port of ``repro/core/mra_decode.py`` (DESIGN.md §7, §9, §11). The KV cache
is viewed as ``nb = S/b`` pages; coarse scores ``q · k̄_y · scale`` against
per-page key means pick the top-``m`` live pages for exact attention, the
query's own live page is force-selected and masked exactly to
``pos_k <= q_pos``, and the remaining live past pages contribute the coarse
background (``variant="full"``).

Ring-paged cache: ``page_blocks`` (B, nb) int32 maps physical page ->
logical block (-1 = never written); position ``p`` lives at physical index
``p % S`` and its block at page ``(p // b) % nb``. ``None`` means the
identity table. Every ``//`` and ``%`` on positions here is floor division
on tensors (Python semantics), so a position of -1 — an idle slot — maps to
block -1 and page ``nb - 1`` exactly as in the reference.

H-level hierarchy (``levels >= 3``, DESIGN.md §14): ``PyramidState.upper``
carries the collapsed levels + tail (``core.hier.HierUpper``) into the
prelude; under ``variant="full"`` their live means join the background
softmax (``variant="sparse"`` ignores them).

Only the page-statistics prelude and the jnp-oracle selection live here:
everything after them runs in ``kernels/chunk_attn.py`` — the hand-written
CUDA kernel on a card, its plain PyTorch twin on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .mra import FORCE_BONUS, NEG_INF, MraConfig


class PyramidState(NamedTuple):
    """Incremental block-sum pyramid over the KV cache.

    k_sum / v_sum: (B, Hkv, nb, D) running sums of keys/values per page.
    upper: the collapsed levels + tail (``core.hier.HierUpper``) of an
      H >= 3 cache; None at H = 2.
    """

    k_sum: torch.Tensor
    v_sum: torch.Tensor
    upper: Optional[NamedTuple] = None

    @staticmethod
    def init(batch: int, kv_heads: int, nb: int, d: int,
             dtype=torch.float32, device=None) -> "PyramidState":
        z = torch.zeros((batch, kv_heads, nb, d), dtype=dtype, device=device)
        return PyramidState(z, z.clone())

    def append(self, k_new, v_new, pos, block: int) -> "PyramidState":
        """Add one token's K/V at position ``pos`` (B,), dense layout only.

        Appends past the ``nb * block`` capacity are dropped (no-op for that
        slot) instead of clamping onto the last block; ring streams go
        through ``ring_pyramid_update``.
        """
        nb = self.k_sum.shape[2]
        blk = pos // block
        in_cap = (blk < nb)[:, None, None]
        b_idx = torch.arange(self.k_sum.shape[0], device=pos.device)
        blk = torch.clamp(blk, max=nb - 1)  # clamp AFTER masking the contribution
        k_sum, v_sum = self.k_sum.clone(), self.v_sum.clone()
        k_sum[b_idx, :, blk] += torch.where(in_cap, k_new.to(k_sum.dtype), 0.0)
        v_sum[b_idx, :, blk] += torch.where(in_cap, v_new.to(v_sum.dtype), 0.0)
        return PyramidState(k_sum, v_sum)


def identity_page_table(batch: int, nb: int, device=None) -> torch.Tensor:
    """Dense layout: physical page y holds logical block y."""
    return torch.arange(nb, dtype=torch.int32, device=device).repeat(batch, 1)


def paged_block_counts(lengths, page_blocks, block: int) -> torch.Tensor:
    """(B, nb) valid tokens per page given the page table and total length."""
    starts = page_blocks * block
    c = torch.clamp(lengths[:, None] - starts, 0, block)
    return torch.where(page_blocks >= 0, c, 0)


def paged_position_mask(lengths, page_blocks, S: int, block: int) -> torch.Tensor:
    """(B, S) validity of each physical cache index under the page table."""
    idx = torch.arange(S, device=page_blocks.device)
    pb = page_blocks[:, idx // block]  # (B, S)
    pos = pb * block + (idx % block)[None, :]
    return (pb >= 0) & (pos < lengths[:, None])


def ring_pyramid_update(pyramid: PyramidState, page_blocks, k_new, v_new, pos,
                        block: int, active=None):
    """Append one token's K/V (B, Hkv, D) at global position ``pos`` (B,).

    The target page is ``(pos // block) % nb``; a token that starts a new
    block recycles the page (drops the evicted block's sums) and moves its
    ownership to the new logical block. Slots with ``active`` False are left
    untouched bit-for-bit. Returns new (PyramidState, page_blocks) tensors.
    """
    nb = pyramid.k_sum.shape[2]
    b_idx = torch.arange(pyramid.k_sum.shape[0], device=pos.device)
    blk = pos // block
    page = blk % nb
    if active is None:
        active = torch.ones(pos.shape, dtype=torch.bool, device=pos.device)
    k_old = pyramid.k_sum[b_idx, :, page]
    v_old = pyramid.v_sum[b_idx, :, page]
    # recycle the page only when an *active* slot writes a block's first token
    keep = ~(active & ((pos % block) == 0))
    k_base = torch.where(keep[:, None, None], k_old, 0.0)
    v_base = torch.where(keep[:, None, None], v_old, 0.0)
    am = active[:, None, None]
    k_sum, v_sum = pyramid.k_sum.clone(), pyramid.v_sum.clone()
    k_sum[b_idx, :, page] = k_base + torch.where(am, k_new.to(k_sum.dtype), 0.0)
    v_sum[b_idx, :, page] = v_base + torch.where(am, v_new.to(v_sum.dtype), 0.0)
    page_blocks = page_blocks.clone()
    old_owner = page_blocks[b_idx, page]
    page_blocks[b_idx, page] = torch.where(active, blk.to(page_blocks.dtype),
                                           old_owner)
    return PyramidState(k_sum, v_sum), page_blocks


def quantize_kv(x):
    """Per-token-per-head int8 quantization. x (B,H,*,D) -> (int8, scale)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def mra2_decode_attention(q, k_cache, v_cache, lengths, cfg: MraConfig, *,
                          decode_blocks: int = 16,
                          pyramid: Optional[PyramidState] = None,
                          page_blocks=None, k_scale=None, v_scale=None):
    """One-step decode attention: the C == 1 chunk at ``lengths - 1``.

    q (B, Hq, 1, D); k_cache/v_cache (B, Hkv, S, D); lengths (B,) valid
    length including the token being decoded. Returns (B, Hq, 1, D).
    """
    return mra2_chunk_attention(
        q, k_cache, v_cache, lengths, (lengths - 1)[:, None], cfg,
        decode_blocks=decode_blocks, pyramid=pyramid, page_blocks=page_blocks,
        k_scale=k_scale, v_scale=v_scale)


def mra2_coarse_decode_attention(q, k_cache, v_cache, lengths, cfg: MraConfig,
                                 *, pyramid: Optional[PyramidState] = None,
                                 page_blocks=None, k_scale=None, v_scale=None):
    """Coarse-only decode: the budget collapsed to the query's own block, so
    every other live page contributes only through its pyramid mean."""
    return mra2_decode_attention(
        q, k_cache, v_cache, lengths, cfg, decode_blocks=1, pyramid=pyramid,
        page_blocks=page_blocks, k_scale=k_scale, v_scale=v_scale)


class ChunkPrelude(NamedTuple):
    """Page statistics shared by the kernel and its plain twin.

    Coarse scoring, the causal block mask, own-block force selection and
    top-m all happen downstream (``_select_pages`` on the plain route,
    inside the CUDA kernel on the card).
    """

    qg: torch.Tensor      # (B, Hkv, G, C, D) grouped queries, compute dtype
    pb: torch.Tensor      # (B, nb) int32 page table (identity when unpaged)
    counts: torch.Tensor  # (B, nb) valid tokens per page, compute dtype
    k_ds: torch.Tensor    # (B, Hkv, nb, D) per-page K means (coarse keys)
    v_ds: torch.Tensor    # (B, Hkv, nb, D) per-page V means
    scale: float
    block_size: int
    upper: Optional[NamedTuple] = None  # core.hier.HierUpper at H >= 3


class PageSelection(NamedTuple):
    """Top-m page selection of the plain route (the kernel's mirror)."""

    coarse_m: torch.Tensor  # (B, Hkv, G, C, nb) masked coarse scores
    y_idx: torch.Tensor     # (B, Hkv, G, C, m) selected physical pages
    sel_ok: torch.Tensor    # (B, Hkv, G, C, m) selection validity
    allowed: torch.Tensor   # (B, 1, 1, C, nb) valid-target support mask
    ownl: torch.Tensor      # (B, 1, 1, C, nb) query's own *live* block


def _chunk_prelude(q, k_cache, v_cache, lengths, q_pos, cfg: MraConfig,
                   decode_blocks, pyramid, page_blocks) -> ChunkPrelude:
    """Page stats shared by the kernel and its plain twin."""
    B, Hq, C, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    b = cfg.block_size
    if Hq % Hkv != 0:
        raise ValueError(
            f"query heads {Hq} (q {tuple(q.shape)}) are not a multiple of KV "
            f"heads {Hkv} (k_cache {tuple(k_cache.shape)}); GQA grouping is "
            "impossible")
    if S % b != 0:
        raise ValueError(
            f"KV cache length {S} (k_cache {tuple(k_cache.shape)}) is not a "
            f"multiple of block_size {b}; the cache cannot be paged into "
            "whole pyramid blocks")
    G = Hq // Hkv
    nb = S // b
    scale = cfg.softmax_scale if cfg.softmax_scale is not None else 1.0 / (D**0.5)
    cdt = torch.float32  # scores and sums in fp32 (the reference's compute dtype)

    pb = (page_blocks if page_blocks is not None
          else identity_page_table(B, nb, device=q.device))
    if tuple(pb.shape) != (B, nb):
        raise ValueError(
            f"page_blocks shape {tuple(pb.shape)} does not match (B, nb) = "
            f"({B}, {nb}) for k_cache {tuple(k_cache.shape)}, block_size {b}")
    counts = paged_block_counts(lengths, pb, b).to(cdt)  # (B, nb)
    if pyramid is None:
        mask = paged_position_mask(lengths, pb, S, b).to(k_cache.dtype)
        k_sum = torch.sum((k_cache * mask[:, None, :, None]).reshape(
            B, Hkv, nb, b, D), dim=3, dtype=cdt)
        v_sum = torch.sum((v_cache * mask[:, None, :, None]).reshape(
            B, Hkv, nb, b, D), dim=3, dtype=cdt)
    else:
        k_sum, v_sum = pyramid.k_sum.to(cdt), pyramid.v_sum.to(cdt)
    denom = torch.clamp(counts, min=1.0)[:, None, :, None]
    k_ds = (k_sum / denom).contiguous()  # (B, Hkv, nb, D)
    v_ds = (v_sum / denom).contiguous()
    qg = q.reshape(B, Hkv, G, C, D).to(cdt).contiguous()
    upper = pyramid.upper if pyramid is not None else None
    return ChunkPrelude(qg, pb.to(torch.int32).contiguous(), counts, k_ds,
                        v_ds, scale, b, upper)


def _select_pages(pre: ChunkPrelude, q_pos, m: int) -> PageSelection:
    """Coarse scores, causal block mask, and top-m selection (plain oracle).

    A page is a valid exact-attention target iff it is live and causally
    allowed; the query's own live block is force-selected through
    FORCE_BONUS, and a *dead* own block is neither forced nor valid, so such
    rows come out as exact zeros. Ties break to the lowest page index, as
    ``jax.lax.top_k`` and the kernel's m argmax rounds do: a stable
    descending sort keeps equal scores in index order (``torch.topk``
    promises no tie order).
    """
    b = pre.block_size
    live = pre.counts > 0  # (B, nb)
    jq = q_pos // b  # (B, C) query block index; -1 for padded rows
    pb_q = pre.pb[:, None, None, None, :]  # (B,1,1,1,nb)
    jq_q = jq[:, None, None, :, None]  # (B,1,1,C,1)
    allowed = live[:, None, None, None, :] & (pb_q <= jq_q)
    ownl = (pb_q == jq_q) & (pb_q >= 0) & live[:, None, None, None, :]
    coarse = torch.einsum("bhgcd,bhyd->bhgcy", pre.qg, pre.k_ds) * pre.scale
    coarse_m = torch.where(allowed, coarse, NEG_INF)  # (B,Hkv,G,C,nb)
    sel_scores = coarse_m + FORCE_BONUS * ownl
    y_idx = torch.sort(sel_scores, dim=-1, descending=True,
                       stable=True).indices[..., :m]
    sel_ok = torch.gather(allowed.expand(sel_scores.shape), -1, y_idx)
    return PageSelection(coarse_m, y_idx, sel_ok, allowed, ownl)


def mra2_chunk_attention(q, k_cache, v_cache, lengths, q_pos, cfg: MraConfig,
                         *, decode_blocks: int = 16,
                         pyramid: Optional[PyramidState] = None,
                         page_blocks=None, k_scale=None, v_scale=None):
    """Chunked-prefill attention: C queries vs. the (ring-paged) KV cache.

    Per query at global position ``p``: the coarse page scores pick the
    top-``m`` live pages among blocks up to ``p // b`` for exact attention,
    the own (partial) block is force-selected and masked to ``pos_k <= p``,
    and the remaining live past pages form the coarse background — joined,
    at H >= 3 under ``variant="full"``, by the live collapsed entries of
    ``pyramid.upper``. With C == 1 and ``q_pos == lengths - 1`` this is the
    decode path.

    Only the page-stats prelude runs here; selection, gather, two-level
    softmax, background and normalization run in
    ``kernels/chunk_attn.chunk_attention_kernel`` — the CUDA kernel for a
    tensor on the card, its plain twin for a tensor on the CPU.

    Args:
      q: (B, Hq, C, D) chunk queries; their K/V must already be in the cache.
      lengths: (B,) total written length (chunk included).
      q_pos: (B, C) global position of each query token.
      page_blocks: (B, nb) ring page table; None = dense identity layout.
      k_scale/v_scale: (B, Hkv, S) per-token dequant scales of an int8 cache.

    Returns:
      (B, Hq, C, D) attention output in q's dtype.
    """
    B, Hq, C, D = q.shape
    if tuple(q_pos.shape) != (B, C):
        raise ValueError(
            f"q_pos shape {tuple(q_pos.shape)} does not match (B, C) = "
            f"({B}, {C}) of q {tuple(q.shape)}")
    if cfg.draft_level > 1:
        raise NotImplementedError(
            "draft_level > 1 (coarser speculative-draft background) is not "
            "ported: the grouped fold needs the CUDA chunk kernel's support "
            "(ROADMAP.md)")
    from repro_torch.kernels.chunk_attn import chunk_attention_kernel

    pre = _chunk_prelude(q, k_cache, v_cache, lengths, q_pos, cfg,
                         decode_blocks, pyramid, page_blocks)
    m = min(decode_blocks, k_cache.shape[2] // cfg.block_size)
    out = chunk_attention_kernel(
        pre, k_cache, v_cache, q_pos, m=m, k_scale=k_scale, v_scale=v_scale,
        include_bg=cfg.variant == "full", mode=cfg.kernel_mode)
    return out.to(q.dtype)


def full_chunk_attention(q, k_cache, v_cache, lengths, q_pos, *,
                         softmax_scale: Optional[float] = None,
                         local_window: Optional[int] = None):
    """Exact chunked-prefill attention oracle: C queries vs. a dense cache.

    Each query at position p attends keys at positions <= p (and, with
    ``local_window``, above p - local_window), in fp32. O(C*S) per chunk.
    """
    B, Hq, C, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    qg = q.reshape(B, Hkv, G, C, D).to(torch.float32)
    s = torch.einsum("bhgcd,bhjd->bhgcj", qg, k_cache.to(torch.float32)) * scale
    kp = torch.arange(S, device=q.device)
    ok = ((kp[None, None, :] <= q_pos[:, :, None])
          & (kp[None, None, :] < lengths[:, None, None]))
    if local_window is not None:
        ok = ok & (kp[None, None, :] > q_pos[:, :, None] - local_window)
    s = torch.where(ok[:, None, None], s, NEG_INF)  # (B,1,1,C,S) broadcast
    p = torch.softmax(s, dim=-1)
    has = ok.any(-1)[:, None, None]  # all-masked rows -> zeros
    out = torch.einsum("bhgcj,bhjd->bhgcd", p, v_cache.to(torch.float32))
    out = torch.where(has[..., None], out, 0.0)
    return out.reshape(B, Hq, C, D).to(q.dtype)


def full_decode_attention(q, k_cache, v_cache, lengths, *,
                          softmax_scale: Optional[float] = None):
    """Exact decode attention oracle, in fp32. O(S) per token; length-0
    slots -> 0."""
    B, Hq, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale = softmax_scale if softmax_scale is not None else 1.0 / (D**0.5)
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bhjd->bhgj", qg, k_cache.to(torch.float32)) * scale
    valid = torch.arange(S, device=q.device) < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgj,bhjd->bhgd", p, v_cache.to(torch.float32))
    has = (lengths > 0)[:, None, None, None]  # all-masked rows -> zeros
    out = torch.where(has, out, 0.0)
    return out.reshape(B, Hq, 1, D).to(q.dtype)
