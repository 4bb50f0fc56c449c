"""Attention dispatch.

Port of ``repro/core/attention.py``: models declare an ``AttentionSpec``;
``self_attention`` (training, full sequence), ``decode_attention`` and
``chunk_attention`` (serving, over the ring-paged cache) route the kinds
``mra2``, ``mra2_s`` (MRA-2 / MRA-2-s) and ``full`` (exact softmax);
``self_attention`` also routes the paper's baselines (``core/baselines.py``,
bidirectional approximators with the KV heads expanded G-fold). The
``local`` kind comes with the recurrentgemma family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import baselines
from .mra import MraConfig, full_attention, mra2_attention
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

    kind: "full" | "mra2" | "mra2_s" (served), or a ``baselines.REGISTRY``
      key (sequence attention only); "local" raises until its slice.
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


def _unported(kind: str) -> Exception:
    if kind == "local":
        return NotImplementedError(
            "local (sliding-window) attention comes with the recurrentgemma "
            "family slice")
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
    fn = baselines.REGISTRY.get(spec.kind)
    if fn is None:
        raise _unported(spec.kind)
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
    if _exact_when_served(spec.kind):
        return full_decode_attention(q, k_cache, v_cache, lengths,
                                     softmax_scale=spec.softmax_scale)
    raise _unported(spec.kind)


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
    if _exact_when_served(spec.kind):
        return full_chunk_attention(q, k_cache, v_cache, lengths, q_pos,
                                    softmax_scale=spec.softmax_scale)
    raise _unported(spec.kind)
