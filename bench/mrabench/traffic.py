"""Traffic from a data file and the seed: serving jobs and training batches.

Serving (``"kind": "serve"``): a job is ``job_requests`` requests handed to
one ``Engine.run``. Every job holds the same multiset of lengths, so every
seed does the same work: prompt lengths at the ``job_requests`` mid-point
quantiles of a log-normal (``prompt.median``, ``prompt.sigma``) clipped to
[``prompt.min``, ``prompt.max``], output lengths evenly over
[``output.min``, ``output.max``]. The seed and the job's index shuffle
both, independently, and draw the token ids uniformly over the vocab.

Training (``"kind": "train"``): step ``i`` of a seed takes ``batch`` rows of
``seq_len + 1`` tokens (inputs and next-token targets): Zipfian unigrams
over the vocab, each row repeating a few earlier spans of 8-32 tokens at
later offsets (a copy of the program's synthetic LM stream, kept here so
that the data cannot change under the benchmark).
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(k) for k in key]))


def prompt_lengths(t: dict) -> list:
    p, n = t["prompt"], t["job_requests"]
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = math.exp(math.log(p["median"]) + p["sigma"] * z)
        out.append(int(min(max(round(x), p["min"]), p["max"])))
    return out


def output_lengths(t: dict) -> list:
    o, n = t["output"], t["job_requests"]
    span = o["max"] - o["min"] + 1
    return [o["min"] + int(span * (i + 0.5) / n) for i in range(n)]


def job(t: dict, vocab: int, seed: int, index: int) -> list:
    """[(prompt int32 array, new tokens)] of job ``index``."""
    order = _rng(1, index)
    plen = order.permutation(prompt_lengths(t))
    olen = order.permutation(output_lengths(t))
    rng = _rng(seed, 1, index)
    return [(rng.integers(0, vocab, size=int(p), dtype=np.int64)
             .astype(np.int32), int(o)) for p, o in zip(plen, olen)]


def warmup_job(t: dict, vocab: int, seed: int) -> list:
    """Requests that run the dispatch shapes of the cell once: every
    slot prefilling a whole chunk, then decoding."""
    rng = _rng(seed, 2)
    n = t["engine"]["slots"]
    c = t["engine"]["chunk"]
    return [(rng.integers(0, vocab, size=c + 1 + i, dtype=np.int64)
             .astype(np.int32), 2) for i in range(n)]


def lm_tokens(rng: np.random.Generator, batch: int, seq: int,
              vocab: int) -> np.ndarray:
    """Zipfian unigrams + local copy structure."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)
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


def train_batch(t: dict, vocab: int, seed: int, step: int,
                warmup: bool = False) -> np.ndarray:
    """(batch, seq_len + 1) int32 tokens of step ``step`` of the window, or
    of the warm-up (rows of their own)."""
    return lm_tokens(_rng(seed, 5 if warmup else 3, step), t["batch"],
                     t["seq_len"] + 1, vocab)
