"""Deterministic synthetic batches (numpy only) and a prefetching loader.

Port of ``repro/data/pipeline.py`` (DESIGN.md §7), kept as the port's own
copy because the reference module imports the JAX package: the same
generator and the same calls, so a (seed, step, shard) gives batches
bit-identical to the reference's. Streams are keyed by the step, so a
restart resumes bit-identically with the step counter as the only data
state. Token streams mix Zipfian unigrams with copy spans, which gives
attention the locality MRA exploits; audio frames (and the stub's vision
patches) are temporally correlated random walks.

The dense, MoE, rwkv6 and recurrentgemma families take LM tokens, hubert
audio frames with an 8% mask and masked-unit targets, internvl vision
patches and text; an unknown family raises ``ValueError``. The
``DataLoader`` makes the next batches in a background thread while the
loop trains on the current one, as the reference's does.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import FAMILIES, ModelConfig, ShapeCfg


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


def _audio_frames(rng, batch, seq, dim):
    steps = rng.standard_normal((batch, seq, dim)).astype(np.float32) * 0.3
    frames = np.cumsum(steps, axis=1)
    frames /= np.maximum(np.abs(frames).max(axis=(1, 2), keepdims=True), 1.0)
    return frames


def make_batch(cfg: ModelConfig, shape: ShapeCfg, *, step: int = 0,
               seed: int = 0, shard: int = 0, num_shards: int = 1,
               batch_override: Optional[int] = None) -> dict:
    """One host-local training batch as numpy arrays, by family:

      dense / moe / rwkv6 / recurrentgemma: {"tokens": (B, S) int32,
        "targets": (B, S) int32};
      hubert: {"frames": (B, S, frontend_dim) f32, "mask_positions": (B, S)
        bool, "targets": (B, S) int32} (targets: the argmax of the frames
        through a fixed random projection, seeded by ``seed`` alone);
      internvl: {"tokens": (B, S_text) int32, "patches": (B, P,
        frontend_dim) f32, "targets": (B, S_text) int32}, P =
        ``num_patches``, S_text = S - P.

    The rng is drawn in the reference's order, so batches are bitwise its.
    """
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; the port "
                         f"has {FAMILIES}")
    B = (batch_override if batch_override is not None
         else shape.global_batch // num_shards)
    S = shape.seq_len
    rng = _rng_for_step(seed, step, shard)
    if cfg.family == "hubert":
        frames = _audio_frames(rng, B, S, cfg.frontend_dim)
        mask = rng.random((B, S)) < 0.08
        proj = _rng_for_step(seed, 0, 0).standard_normal(
            (cfg.frontend_dim, cfg.vocab))
        targets = (frames @ proj.astype(np.float32)).argmax(-1).astype(np.int32)
        return {"frames": frames, "mask_positions": mask, "targets": targets}
    if cfg.family == "internvl":
        P = cfg.num_patches
        toks = _lm_tokens(rng, B, S - P + 1, cfg.vocab)
        patches = _audio_frames(rng, B, P, cfg.frontend_dim)
        return {"tokens": toks[:, :-1], "patches": patches,
                "targets": toks[:, 1:].astype(np.int32)}
    toks = _lm_tokens(rng, B, S + 1, cfg.vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:].astype(np.int32)}


class DataLoader:
    """Iterator of ``(step, batch)`` over ``make_batch`` from ``start_step``.

    A worker thread makes the batches ahead into a queue of ``prefetch``
    entries; ``close()`` stops it and waits for it to end, so call it when
    done (``train()`` does, in a ``finally``).
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeCfg, *, seed: int = 0,
                 start_step: int = 0, shard: int = 0, num_shards: int = 1,
                 batch_override: Optional[int] = None, prefetch: int = 2):
        self.cfg, self.shape = cfg, shape
        self.seed, self.shard, self.num_shards = seed, shard, num_shards
        self.batch_override = batch_override
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                item = (step, make_batch(
                    self.cfg, self.shape, step=step, seed=self.seed,
                    shard=self.shard, num_shards=self.num_shards,
                    batch_override=self.batch_override))
            except Exception as err:  # raised again by __next__
                item = err
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the worker and wait for it; drops the batches made ahead."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
