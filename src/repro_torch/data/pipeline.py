"""Deterministic synthetic token streams for the dense family (numpy only).

Port of ``repro/data/pipeline.py`` (DESIGN.md §7), kept as the port's own
copy because the reference module imports the JAX package: the same
generator and the same calls, so a (seed, step, shard) gives batches
bit-identical to the reference's. Streams are keyed by the step, so a
restart resumes bit-identically with the step counter as the only data
state. Token streams mix Zipfian unigrams with copy spans, which gives
attention the locality MRA exploits.

The loader has no prefetch thread: a batch is made when the loop asks.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCfg


def _rng_for_step(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


def _lm_tokens(rng: np.random.Generator, batch: int, seq: int,
               vocab: int) -> np.ndarray:
    """Zipfian unigrams + local copy structure (gives MRA-friendly locality)."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)
    # copy spans: each sequence repeats an earlier span at a random offset
    n_spans = max(1, seq // 256)
    for b in range(batch):
        for _ in range(n_spans):
            ln = min(int(rng.integers(8, 33)), max(seq // 3, 1))
            if seq < 3 * ln:
                continue
            src = int(rng.integers(0, seq - 2 * ln + 1))
            dst = int(rng.integers(src + ln, seq - ln + 1))
            toks[b, dst: dst + ln] = toks[b, src: src + ln]
    return toks


def make_batch(cfg: ModelConfig, shape: ShapeCfg, *, step: int = 0,
               seed: int = 0, shard: int = 0, num_shards: int = 1,
               batch_override: Optional[int] = None) -> dict:
    """One host-local training batch as numpy arrays:
    {"tokens": (B, S) int32, "targets": (B, S) int32}."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense family's batches are "
            "ported")
    B = (batch_override if batch_override is not None
         else shape.global_batch // num_shards)
    S = shape.seq_len
    rng = _rng_for_step(seed, step, shard)
    toks = _lm_tokens(rng, B, S + 1, cfg.vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:].astype(np.int32)}


class DataLoader:
    """Iterator of ``(step, batch)`` over ``make_batch`` from ``start_step``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, *, seed: int = 0,
                 start_step: int = 0):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self._step = start_step

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step = self._step
        batch = make_batch(self.cfg, self.shape, step=step, seed=self.seed)
        self._step += 1
        return step, batch
