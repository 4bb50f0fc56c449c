"""Attention dispatch.

Port of ``repro/core/attention.py``: models declare an ``AttentionSpec``;
``self_attention`` (training, full sequence), ``decode_attention`` and
``chunk_attention`` (serving, over the ring-paged cache) route the kinds
``mra2``, ``mra2_s`` (MRA-2 / MRA-2-s) and ``full`` (exact softmax). The
``local`` kind and the baselines come with their families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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

    kind: "full" | "mra2" | "mra2_s" (served); "local" and the baseline
      kinds raise until their slices.
    block_size / blocks_per_row: MRA-2 parameters.
    decode_blocks: MRA serving budget (exact KV pages per query).
    coarse_only: MRA draft mode — the budget is the mandatory own block.
    kernel_mode: serving-kernel tile shape: "latency" | "throughput" |
      "auto" (decode -> latency, chunks -> throughput).
    kv_quant: int8 KV cache with per-token-per-head scales.
    levels: H-level pyramid; only levels == 2 is served yet.
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


def _unported(kind: str) -> NotImplementedError:
    if kind == "local":
        return NotImplementedError(
            "local (sliding-window) attention comes with the recurrentgemma "
            "family slice")
    return NotImplementedError(
        f"attention kind {kind!r} is not served by the port yet (the "
        "baselines come with the baselines/benchmarks slice)")


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
    raise _unported(spec.kind)


def decode_attention(q, k_cache, v_cache, lengths, spec: AttentionSpec, *,
                     pyramid=None, page_blocks=None, k_scale=None,
                     v_scale=None):
    """Single-token decode attention against a KV cache."""
    if spec.kind in MRA_KINDS:
        return mra2_decode_attention(
            q, k_cache, v_cache, lengths, spec.mra_config(causal=True),
            decode_blocks=spec.budget_blocks, pyramid=pyramid,
            page_blocks=page_blocks, k_scale=k_scale, v_scale=v_scale)
    if spec.kind == "full":
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
    if spec.kind == "full":
        return full_chunk_attention(q, k_cache, v_cache, lengths, q_pos,
                                    softmax_scale=spec.softmax_scale)
    raise _unported(spec.kind)
