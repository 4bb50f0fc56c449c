"""Resolution-speculative decoding: coarse-pyramid drafts + one chunked verify.

Port of ``repro/serve/speculative.py`` (DESIGN.md §10). The pyramid block
sums the ring-paged cache already keeps are a cheap low-resolution view of
the whole context, so the served model under coarse-only attention (the
budget cut to each query's own block; every other page through its mean)
is a free draft model. Per round, for every slot of the decode wave:

  1. snapshot — ``kv.spec_snapshot`` copies the bounded window the round
     may change (the cache updates in place);
  2. draft — K ``decode_step`` dispatches under the coarse-only spec
     propose K tokens autoregressively, writing draft K/V like decode;
  3. rewind — the drafts' approximate writes are rolled back;
  4. verify — ONE ``prefill_chunk`` dispatch feeds [fed token, drafts] as
     a (K+1)-token chunk, rewrites the window with exact full-MRA K/V and
     returns the target distribution after every draft (and the chunk's
     fp32 K/V);
  5. accept — ``sampling.spec_verify_batch`` rejection-samples per slot
     (greedy: the argmax-prefix match, so greedy speculative decoding is
     token-identical to plain decoding); a last ``spec_rewind`` trims each
     slot to its accepted prefix + correction token, replaying the kept
     positions' pyramid contributions.

On a card every draft and verify dispatch runs the CUDA chunk kernel in
every layer: drafts at C = 1 with the budget m = 1 (split decode and its
combine; at ``draft_level > 1`` with the grouped far field), verifies at
C = K + 1. Slots outside the round ride along
untouched (``active`` / ``num_valid`` masking).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import MRA_KINDS

from .sampling import draft_batch, spec_verify_batch

__all__ = ["SpecDecoder", "draft_config"]


def draft_config(cfg: ModelConfig, draft_level: int = 1) -> ModelConfig:
    """The draft model IS the target model under coarse-only attention.

    ``draft_level`` > 1 coarsens the draft's background one more rung
    (DESIGN.md §14): a group of 2^(draft_level-1) adjacent pages that are
    all background for a row folds through its merged mean. The fold runs
    in the CUDA chunk kernel on a card (the reference runs it on its jnp
    route only) and in its plain twin on the CPU; verify dispatches keep
    the target config.
    """
    if draft_level < 1:
        raise ValueError(f"draft_level must be >= 1, got {draft_level}")
    return cfg.replace(attention=cfg.attention.replace(
        coarse_only=True, draft_level=draft_level))


class SpecDecoder:
    """Drives one speculative round per engine iteration (``spec_k``)."""

    def __init__(self, cfg: ModelConfig, spec_k: int, draft_level: int = 1):
        if cfg.attention.kind not in MRA_KINDS:
            raise NotImplementedError(
                "speculative decoding drafts through the MRA pyramid; "
                f"attention kind {cfg.attention.kind!r} has no coarse level")
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.cfg = cfg
        self.dcfg = draft_config(cfg, draft_level)
        self.k = spec_k

    def split_wave(self, kv, active: np.ndarray):
        """(speculable, plain) split of the decode wave.

        A slot is speculable when its round window (L0, L0 + K] holds no
        ring-eviction boundary (a block start at a position >= the fine
        window ``kv.window_tokens``): a chunked verify writes the whole
        window before attending, so a boundary inside it would evict (at
        H >= 3 collapse) a block the window's earlier queries still see in
        sequential decode. A boundary exactly at L0 is fine — the fed
        token's write evicts it for every query, as decode does. The other
        slots take a plain decode wave, up to K waves before each crossing.
        """
        L0 = kv.lengths.astype(np.int64)
        last_boundary = (L0 + self.k) // kv.block * kv.block
        unsafe = (last_boundary > L0) & (last_boundary >= kv.window_tokens)
        return active & ~unsafe, active & unsafe

    def round(self, engine, sched, active: np.ndarray) -> None:
        """One batched draft(K) -> rewind -> verify -> accept -> trim round
        over the ``active`` slots; the other slots keep every byte."""
        K, kv, tel = self.k, engine.kv, engine.telemetry
        dev, vocab = engine.device, self.cfg.vocab
        snap = kv.spec_snapshot(K + 1)
        act = torch.as_tensor(active, device=dev)
        fed = torch.as_tensor(sched.feed_tokens(), dtype=torch.int64,
                              device=dev)
        temp, top_k, top_p, seed, step0 = sched.sampler_arrays()

        tok, drafts, qs = fed, [], []
        for j in range(K):
            with tel.dispatch("draft", hist="draft_seconds", step=j):
                logits, _ = engine.model.decode_step(
                    engine.params, self.dcfg, kv.tree, kv.rows(tok),
                    active=kv.rows(act))
                logits = kv.whole(logits)
                q, nxt = draft_batch(logits, temp, top_k, top_p, seed,
                                     step0 + j, vocab=vocab)
                tok = torch.where(act, nxt.to(tok.dtype), tok)
                engine._sync()
            drafts.append(tok)
            qs.append(q)
            tel.metrics.inc("draft_dispatches")
        # roll the drafts' approximate writes back before the exact rewrite
        kv.spec_rewind(snap, snap["lengths"], act)

        chunk = torch.stack([fed] + drafts, dim=1)  # (B, K+1)
        num_valid = torch.where(act, K + 1, 0).to(torch.int32)
        with tel.dispatch("verify", hist="verify_seconds", k=K):
            logits, _, chunk_kv = engine.model.prefill_chunk(
                engine.params, self.cfg, kv.tree, kv.rows(chunk),
                kv.rows(num_valid), all_logits=True, collect_kv=True)
            logits = kv.whole(logits)
            out, n_out, n_acc = spec_verify_batch(
                logits, torch.stack(drafts, dim=1), torch.stack(qs, dim=1),
                temp, top_k, top_p, seed, step0, act, vocab=vocab)
            # trim each slot to accepted prefix + correction/bonus token: the
            # last emitted token is never fed, so the kept stream is L0 + n_out
            kv.spec_rewind(snap, snap["lengths"] + n_out, act, chunk_kv)
            out, n_out, n_acc = (x.cpu().numpy() for x in (out, n_out, n_acc))
        tel.metrics.inc("verify_dispatches")

        emitted = 0
        for s in np.flatnonzero(active):
            emitted += sched.on_spec_tokens(int(s), out[s, : n_out[s]],
                                            int(n_acc[s]))
        m = tel.metrics
        m.inc("generated_tokens", emitted)
        m.inc("spec_rounds")
        m.inc("spec_drafted_tokens", int(K * active.sum()))
        m.inc("spec_accepted_tokens", int(n_acc[active].sum()))
        # delivered to requests (surplus past max_new_tokens is dropped)
        m.inc("spec_emitted_tokens", emitted)
