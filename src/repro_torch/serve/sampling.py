"""Token sampling for the serving engine: greedy / temperature / top-k / top-p.

Port of ``repro/serve/sampling.py``. Determinism contract: the random draw
for a request's ``i``-th sampled token comes from a ``torch.Generator``
seeded from ``(seed, i)`` alone — never from the slot it landed in, the
batch around it, or wall-clock state — so batched engine output is
bit-identical to a single-request run with the same seed on the same
device. The draws differ from the reference's JAX PRNG bits; the tests
compare sampled output by distribution.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch

from repro_torch.core.mra import NEG_INF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    temperature: 0 (or negative) = greedy argmax; > 0 = softmax sampling.
    top_k: keep only the k highest logits (0 = disabled).
    top_p: nucleus sampling — keep the smallest prefix of the sorted
      distribution with cumulative probability >= top_p (1.0 = disabled).
    seed: request-level sampling seed (see the determinism contract).
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


def request_generator(seed: int, step: int, device) -> torch.Generator:
    """Generator for a request's ``step``-th sampled token: a pure function
    of (seed, step) through a 64-bit hash of the pair."""
    digest = hashlib.blake2b(f"{int(seed)}:{int(step)}".encode(),
                             digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return gen


def _masked_logits(logits, vocab):
    lf = logits.to(torch.float32)
    V = logits.shape[-1]
    if vocab is not None and vocab < V:
        lf = torch.where(torch.arange(V, device=lf.device) < vocab, lf, NEG_INF)
    return lf


def greedy_batch(logits, *, vocab=None):
    """Vocab-masked argmax (first index among ties), the temperature == 0
    path of ``sample_batch`` exactly."""
    return torch.argmax(_masked_logits(logits, vocab), dim=-1).to(torch.int32)


def filtered_logits(logits, temperature, top_k, top_p, *, vocab=None):
    """Temperature-scaled, top-k/top-p-filtered logits: (B, V) -> (B, V).

    ``softmax(filtered_logits(...))`` is the exact distribution
    ``sample_batch`` draws from for a temperature > 0 slot.
    """
    V = logits.shape[-1]
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    lf = _masked_logits(logits, vocab)
    scaled = lf / torch.clamp(temperature, min=1e-6)[:, None]
    # top-k: mask everything below the k-th largest logit (ties kept)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, torch.clamp(top_k, 1, V), V)
    kth = torch.gather(sorted_desc, -1, k[:, None] - 1)  # (B, 1)
    scaled = torch.where(scaled >= kth, scaled, NEG_INF)
    # top-p over the top-k-filtered distribution, from the same sort; the
    # argmax always survives, so top_p -> 0 degenerates to greedy
    sdesc = torch.where(torch.arange(V, device=dev)[None, :] < k[:, None],
                        sorted_desc, NEG_INF)
    p_sorted = torch.softmax(sdesc, dim=-1)
    csum = torch.cumsum(p_sorted, dim=-1)
    keep = (csum - p_sorted) < top_p[:, None]
    n_keep = torch.clamp(keep.sum(-1), min=1)
    cutoff = torch.gather(sdesc, -1, n_keep[:, None] - 1)
    return torch.where(scaled >= cutoff, scaled, NEG_INF)


def sample_batch(logits, temperature, top_k, top_p, seed, step, *, vocab=None):
    """Sample one token per slot; sampler params are per-slot host arrays.

    Args:
      logits: (B, V) next-token logits (V may include vocab padding).
      temperature/top_p: (B,) float; top_k/seed/step: (B,) int.
      vocab: real vocab size — padded logit columns are masked out.

    Returns:
      (B,) int32 token ids on the logits' device.
    """
    greedy_tok = greedy_batch(logits, vocab=vocab)
    temps = [float(t) for t in temperature]
    if not any(t > 0.0 for t in temps):
        return greedy_tok
    scaled = filtered_logits(logits, temperature, top_k, top_p, vocab=vocab)
    out = greedy_tok.clone()
    for b, t in enumerate(temps):
        if t <= 0.0:
            continue
        # Gumbel-max: argmax(logits + Gumbel noise) ~ softmax(logits)
        gen = request_generator(seed[b], step[b], logits.device)
        u = torch.rand(scaled.shape[-1], generator=gen, device=logits.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        out[b] = torch.argmax(scaled[b] - torch.log(-torch.log(u))).to(out.dtype)
    return out
