"""MRA-2 constants and the serving fields of ``MraConfig``.

Port of ``repro/core/mra.py`` for the serving slice: the finite sentinels
shared by every selection path and the configuration the chunk/decode
attention reads. The full-sequence ``mra2_attention`` (training and
whole-prompt prefill) comes with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

NEG_INF = -1e9  # finite "minus infinity": exp(NEG_INF - c) underflows to 0, no NaNs
FORCE_BONUS = 2e9  # added to coarse scores of blocks that must be selected


@dataclasses.dataclass(frozen=True)
class MraConfig:
    """Serving configuration of the MRA-2 approximation.

    Attributes:
      block_size: side length b of the blocks (= ring-cache page size).
      variant: "full" = MRA-2 (coarse background kept), "sparse" = MRA-2-s.
      softmax_scale: score scale; None -> 1/sqrt(head_dim).
      kernel_mode: serving-kernel tile shape (kernels/chunk_attn.py) —
        "latency" (single-query tiles) | "throughput" (multi-query tiles) |
        "auto" (resolved per call from the chunk width).
      draft_level: background resolution of speculative drafts; only 1 is
        served until the speculative slice.
    """

    block_size: int = 32
    variant: str = "full"
    softmax_scale: Optional[float] = None
    kernel_mode: str = "auto"
    draft_level: int = 1
