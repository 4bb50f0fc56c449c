"""Attention dispatch.

Port of ``repro/core/attention.py``: models declare an ``AttentionSpec``;
``self_attention`` (training, full sequence), ``decode_attention`` and
``chunk_attention`` (serving, over the ring-paged cache) route the kinds
``mra2``, ``mra2_s`` (MRA-2 / MRA-2-s) and ``full`` (exact softmax);
``self_attention`` also routes the paper's baselines (``core/baselines.py``,
bidirectional approximators with the KV heads expanded G-fold), and every
entry point the ``local`` kind: exact sliding-window attention over the
last ``local_window`` positions (recurrentgemma's local layers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import baselines
from .mra import NEG_INF, MraConfig, full_attention, mra2_attention
from .mra_decode import (
    full_chunk_attention,
    full_decode_attention,
    mra2_chunk_attention,
    mra2_decode_attention,
)

MRA_KINDS = ("mra2", "mra2_s")


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Which attention mechanism a model layer uses.

    kind: "full" | "mra2" | "mra2_s" | "local" (served), or a
      ``baselines.REGISTRY`` key (sequence attention only).
    block_size / blocks_per_row: MRA-2 parameters.
    decode_blocks: MRA serving budget (exact KV pages per query).
    coarse_only: MRA draft mode — the budget is the mandatory own block.
    kernel_mode: serving-kernel tile shape: "latency" | "throughput" |
      "auto" (decode -> latency, chunks -> throughput).
    kv_quant: int8 KV cache with per-token-per-head scales.
    levels: H-level pyramid (``core/hier.py``, DESIGN.md §14): 2 is the
      two-level ring; >= 3 collapses evicted pages into coarser rings and
      an fp32 tail, so a slot serves contexts past its fine window.
    hier_pages: entries per collapsed level (0 = the fine page count).
    draft_level: background resolution of coarse drafts; only 1 yet.
    local_window: window of kind "local" (recurrentgemma's local layers).
    """

    kind: str = "full"
    block_size: int = 32
    blocks_per_row: int = 4
    decode_blocks: int = 16
    coarse_only: bool = False
    softmax_scale: Optional[float] = None
    kernel_mode: str = "auto"
    kv_quant: bool = False
    levels: int = 2
    hier_pages: int = 0
    draft_level: int = 1
    local_window: int = 1024

    @property
    def budget_blocks(self) -> int:
        """Decode-time selection budget (1 when coarse-only: own block)."""
        return 1 if self.coarse_only else self.decode_blocks

    def mra_config(self, causal: bool) -> MraConfig:
        return MraConfig(
            block_size=self.block_size,
            blocks_per_row=1 if self.coarse_only else self.blocks_per_row,
            variant="sparse" if self.kind == "mra2_s" else "full",
            causal=causal,
            softmax_scale=self.softmax_scale,
            kernel_mode=self.kernel_mode,
            draft_level=self.draft_level,
        )

    def replace(self, **kw) -> "AttentionSpec":
        return dataclasses.replace(self, **kw)


def _unknown(kind: str) -> Exception:
    return ValueError(f"unknown attention kind {kind!r}")


def _exact_when_served(kind: str) -> bool:
    """Serving attends exactly under ``full`` and, as in the reference,
    under every baseline kind (the baselines approximate full sequences)."""
    return kind == "full" or kind in baselines.REGISTRY


def self_attention(q, k, v, spec: AttentionSpec, *, causal=False,
                   key_mask=None):
    """Sequence self-attention (training). q (B,Hq,N,D), k/v (B,Hkv,N,D)."""
    if spec.kind in MRA_KINDS:
        return mra2_attention(q, k, v, spec.mra_config(causal),
                              key_mask=key_mask)
    if spec.kind == "full":
        return full_attention(q, k, v, causal=causal,
                              softmax_scale=spec.softmax_scale,
                              key_mask=key_mask)
    if spec.kind == "local":
        return _local_attention(q, k, v, spec, causal=causal,
                                key_mask=key_mask)
    fn = baselines.REGISTRY.get(spec.kind)
    if fn is None:
        raise _unknown(spec.kind)
    # baselines are bidirectional approximators (the paper's protocol); GQA
    # by expanding the KV heads
    G = q.shape[1] // k.shape[1]
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=1)
        v = torch.repeat_interleave(v, G, dim=1)
    return fn(q, k, v, softmax_scale=spec.softmax_scale)


def decode_attention(q, k_cache, v_cache, lengths, spec: AttentionSpec, *,
                     pyramid=None, page_blocks=None, k_scale=None,
                     v_scale=None):
    """Single-token decode attention against a KV cache."""
    if spec.kind in MRA_KINDS:
        return mra2_decode_attention(
            q, k_cache, v_cache, lengths, spec.mra_config(causal=True),
            decode_blocks=spec.budget_blocks, pyramid=pyramid,
            page_blocks=page_blocks, k_scale=k_scale, v_scale=v_scale)
    if spec.kind == "local":
        return _local_decode_attention(q, k_cache, v_cache, lengths, spec)
    if _exact_when_served(spec.kind):
        return full_decode_attention(q, k_cache, v_cache, lengths,
                                     softmax_scale=spec.softmax_scale)
    raise _unknown(spec.kind)


def chunk_attention(q, k_cache, v_cache, lengths, q_pos, spec: AttentionSpec,
                    *, pyramid=None, page_blocks=None, k_scale=None,
                    v_scale=None):
    """Chunked-prefill attention: C queries (already written to the cache)
    attend the KV cache causally at their global positions ``q_pos`` (B, C).
    """
    if spec.kind in MRA_KINDS:
        return mra2_chunk_attention(
            q, k_cache, v_cache, lengths, q_pos, spec.mra_config(causal=True),
            decode_blocks=spec.budget_blocks, pyramid=pyramid,
            page_blocks=page_blocks, k_scale=k_scale, v_scale=v_scale)
    if spec.kind == "local" or _exact_when_served(spec.kind):
        window = spec.local_window if spec.kind == "local" else None
        return full_chunk_attention(q, k_cache, v_cache, lengths, q_pos,
                                    softmax_scale=spec.softmax_scale,
                                    local_window=window)
    raise _unknown(spec.kind)


def _local_attention(q, k, v, spec: AttentionSpec, *, causal, key_mask):
    """Sliding-window attention (recurrentgemma's local layers).

    Banded block attention: with bs = min(w, N) and N padded to a multiple
    of bs, each query block attends its own key block and the one before
    (and after, non-causal); causal keys j <= i with i - j < w, non-causal
    |i - j| <= w // 2. O(N * w), in fp32.
    """
    B, Hq, N, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    w = spec.local_window
    bs = min(w, N)
    pad = (-N) % bs
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (q, k, v))
    n = q.shape[2]
    nb = n // bs
    scale = (spec.softmax_scale if spec.softmax_scale is not None
             else 1.0 / (D**0.5))
    qb = q.reshape(B, Hkv, G, nb, bs, D).to(torch.float32)
    kb = k.reshape(B, Hkv, nb, bs, D).to(torch.float32)
    vb = v.reshape(B, Hkv, nb, bs, D).to(torch.float32)
    dev = q.device
    if key_mask is None:
        key_mask = (torch.arange(n, device=dev) < N)[None].expand(B, n)
    else:
        key_mask = torch.nn.functional.pad(key_mask.to(torch.bool),
                                           (0, n - key_mask.shape[1]))
    mb = key_mask.reshape(B, nb, bs)
    blk = torch.arange(nb, device=dev)
    qi = torch.arange(bs, device=dev)[:, None]
    scores, vals = [], []
    for sh in ((-1, 0) if causal else (-1, 0, 1)):
        kk = torch.roll(kb, -sh, dims=2)
        vv = torch.roll(vb, -sh, dims=2)
        mm = torch.roll(mb, -sh, dims=1)
        ok_blk = (blk + sh >= 0) & (blk + sh < nb)
        s = torch.einsum("bhgnid,bhnjd->bhgnij", qb, kk) * scale
        kj = torch.arange(bs, device=dev)[None, :] + sh * bs
        if causal:
            dist_ok = (kj <= qi) & (qi - kj < w)
        else:
            dist_ok = (qi - kj).abs() <= w // 2
        mask = dist_ok & ok_blk[:, None, None]  # (nb, bs, bs)
        mask = mask[None, None, None] & mm[:, None, None, :, None, :]
        scores.append(torch.where(mask, s, NEG_INF))
        vals.append(vv)
    p = torch.softmax(torch.cat(scores, dim=-1), dim=-1)
    out = torch.einsum("bhgnij,bhnjd->bhgnid", p, torch.cat(vals, dim=-2))
    return out.reshape(B, Hq, n, D)[:, :, :N].to(q.dtype)


def _local_decode_attention(q, k_cache, v_cache, lengths, spec: AttentionSpec):
    """Decode attention restricted to the last ``local_window`` positions."""
    B, Hq, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    pos = torch.arange(S, device=q.device)[None, :]
    ok = ((pos < lengths[:, None])
          & (pos >= lengths[:, None] - spec.local_window))
    scale = (spec.softmax_scale if spec.softmax_scale is not None
             else 1.0 / (D**0.5))
    qg = q.reshape(B, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bhgd,bhjd->bhgj", qg, k_cache.to(torch.float32)) * scale
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgj,bhjd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(B, Hq, 1, D).to(q.dtype)
