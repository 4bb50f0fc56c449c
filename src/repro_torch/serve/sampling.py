"""Token sampling for the serving engine: greedy / temperature / top-k / top-p.

Port of ``repro/serve/sampling.py``. Determinism contract: the random draw
for a request's ``i``-th sampled token comes from a ``torch.Generator``
seeded from ``(seed, i)`` alone — never from the slot it landed in, the
batch around it, or wall-clock state — so batched engine output is
bit-identical to a single-request run with the same seed on the same
device. The draws differ from the reference's JAX PRNG bits; the tests
compare sampled output by distribution.

Speculative decoding (DESIGN.md §10) extends the contract: every extra
random decision about a request's ``i``-th token — drafting it, accepting
it, resampling it on rejection — draws from ``spec_key(seed, i, tag)`` with
a fixed tag per role, so speculative serving stays a pure function of
(seed, token index) and batched == solo holds bit for bit. Accept and
resample are standard rejection sampling (Leviathan et al., 2023): accept
draft ``d`` with probability ``min(1, p(d) / q(d))``, resample a rejection
from ``norm(max(p - q, 0))``; the emitted distribution is exactly ``p``.
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


# speculative-decoding generator roles (see the determinism contract): the
# draft proposal, the accept test and the rejection resample of token i
SPEC_DRAFT_TAG = 1
SPEC_ACCEPT_TAG = 2
SPEC_RESID_TAG = 3


def _generator(key: str, device) -> torch.Generator:
    digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return gen


def request_generator(seed: int, step: int, device) -> torch.Generator:
    """Generator for a request's ``step``-th sampled token: a pure function
    of (seed, step) through a 64-bit hash of the pair."""
    return _generator(f"{int(seed)}:{int(step)}", device)


def spec_key(seed: int, step: int, tag: int, device) -> torch.Generator:
    """Generator for a speculative decision (``tag``) about the request's
    ``step``-th token: a pure function of (seed, step, tag), distinct from
    ``request_generator``'s for every tag."""
    return _generator(f"{int(seed)}:{int(step)}:{int(tag)}", device)


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


def _gumbel_argmax(scaled, gen):
    """One draw from softmax(scaled) (V,) by Gumbel-max with ``gen``."""
    u = torch.rand(scaled.shape[-1], generator=gen, device=scaled.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(scaled - torch.log(-torch.log(u)))


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
        out[b] = _gumbel_argmax(scaled[b], gen).to(out.dtype)
    return out


def draft_batch(logits, temperature, top_k, top_p, seed, step, *, vocab=None):
    """Draft-propose one token per slot, with its proposal distribution.

    The filtering of ``sample_batch``, drawn with ``spec_key(...,
    SPEC_DRAFT_TAG)``: a proposal must not spend the draw the oracle makes
    for the token index it speculates about.

    Returns:
      (q_probs (B, V) fp32 filtered proposal distribution — zeros when no
       slot samples, since the greedy accept rule never reads it —,
       tokens (B,) int32 on the logits' device; the greedy argmax for
       temperature <= 0 slots).
    """
    greedy_tok = greedy_batch(logits, vocab=vocab)
    temps = [float(t) for t in temperature]
    if not any(t > 0.0 for t in temps):
        return torch.zeros(logits.shape, dtype=torch.float32,
                           device=logits.device), greedy_tok
    scaled = filtered_logits(logits, temperature, top_k, top_p, vocab=vocab)
    q_probs = torch.softmax(scaled, dim=-1)
    out = greedy_tok.clone()
    for b, t in enumerate(temps):
        if t > 0.0:
            gen = spec_key(seed[b], step[b], SPEC_DRAFT_TAG, logits.device)
            out[b] = _gumbel_argmax(scaled[b], gen).to(out.dtype)
    return q_probs, out


def spec_residual(p, q):
    """Rejection-resample logits: ``log(max(p - q, 0))`` with an
    empty-support guard (p == q everywhere only happens with acceptance
    probability 1; the fallback to ``log p`` catches float underflow).
    Entries without residual mass are -inf, probability 0 — what the
    reference's 1e-38 floor becomes once its CPU and TPU flush that
    subnormal to zero."""
    resid = torch.clamp(p - q, min=0.0)
    has = resid.sum(-1, keepdim=True) > 0.0
    return torch.log(torch.where(has, resid, p))


def spec_verify_batch(logits, draft, q_probs, temperature, top_k, top_p, seed,
                      step0, active, *, vocab=None):
    """Verify K drafted tokens per slot against the target logits.

    Rejection sampling per slot with ragged acceptance: draft i is accepted
    with probability ``min(1, p_i(d_i) / q_i(d_i))`` (p, q the filtered
    target and draft distributions); the first rejection emits a resample
    from ``norm(max(p_i - q_i, 0))`` and drops the rest; full acceptance
    emits a bonus token from the (K+1)-th target distribution with the
    ordinary ``request_generator`` draw — the one the non-speculative
    engine makes at that index. Greedy slots (temperature <= 0) accept
    while the draft equals the target argmax and emit the argmax at the
    first mismatch, so greedy speculative decoding is token-identical to
    plain decoding.

    Args:
      logits: (B, K+1, V) target logits; ``[:, i]`` is the distribution of
        token index ``step0 + i``.
      draft: (B, K) drafted tokens; q_probs (B, K, V) their proposal
        distributions (``draft_batch``).
      temperature/top_p: (B,) float; top_k/seed/step0: (B,) int host arrays,
        ``step0`` the token index of the first draft.
      active: (B,) bool tensor — other slots emit nothing.

    Returns:
      (out (B, K+1) int32 — column j the j-th token emitted this round —,
       n_out (B,) int32 emitted count (accepted + 1; 0 where inactive),
       n_acc (B,) int32 accepted drafts), on the logits' device.
    """
    B, Kp1, V = logits.shape
    K = Kp1 - 1
    dev = logits.device
    temps = [float(t) for t in temperature]
    greedy_tok = greedy_batch(logits.reshape(B * Kp1, V),
                              vocab=vocab).reshape(B, Kp1)
    draft = draft.to(torch.int32)
    sampling = [b for b, t in enumerate(temps) if t > 0.0]
    alive = active
    n_acc = torch.zeros((B,), dtype=torch.int32, device=dev)
    outs = []
    for i in range(K):
        d = draft[:, i]
        acc = d == greedy_tok[:, i]  # the greedy rule; sampled rows below
        fix = greedy_tok[:, i].clone()
        if sampling:
            scaled = filtered_logits(logits[:, i], temperature, top_k, top_p,
                                     vocab=vocab)
            p = torch.softmax(scaled, dim=-1)
            q = q_probs[:, i]
            pd = torch.gather(p, -1, d[:, None].long())[:, 0]
            qd = torch.gather(q, -1, d[:, None].long())[:, 0]
            resid = spec_residual(p, q)
            for b in sampling:
                u = torch.rand((), generator=spec_key(
                    seed[b], int(step0[b]) + i, SPEC_ACCEPT_TAG, dev),
                    device=dev)
                # u < pd/qd without the divide (drafts have q(d) > 0)
                acc[b] = u * qd[b] < pd[b]
                fix[b] = _gumbel_argmax(resid[b], spec_key(
                    seed[b], int(step0[b]) + i, SPEC_RESID_TAG, dev))
        acc = acc & alive
        outs.append(torch.where(acc, d, fix))
        n_acc = n_acc + acc.to(torch.int32)
        alive = acc
    # bonus token after full acceptance: the ordinary draw for step0 + K
    # (read only where every draft was accepted)
    bonus = sample_batch(logits[:, K], temperature, top_k, top_p, seed,
                         [int(s) + K for s in step0], vocab=vocab)
    out = torch.stack(outs + [bonus.to(torch.int32)], dim=1)
    n_out = torch.where(active, n_acc + 1, 0).to(torch.int32)
    return out, n_out, n_acc
