"""Serving engine: ragged continuous batching with chunked prefill + sampling.

Port of ``repro/serve/engine.py`` (DESIGN.md §9). Per engine iteration:

  1. admission — pending requests bind to FREE slots; the slot's cache rows
     are reset bit-exactly (``RingPagedKVCache.reset_slots``).
  2. chunked prefill — ONE ``prefill_chunk`` dispatch advances every
     PREFILL slot by up to ``chunk`` prompt tokens (ragged ``num_valid``).
     Slots whose prompt completes sample their first token from the
     chunk's last-position logits.
  3. decode — ONE ``decode_step`` + sampling dispatch advances every DECODE
     slot (active-masked: other slots' state is untouched bit-for-bit).

On a card every layer of both dispatches runs MRA chunk/decode attention
through the CUDA kernel (``kernels/chunk_attn.py``). Speculative decoding,
mesh serving and the typed telemetry of the reference come with later
slices; the engine keeps plain counters and per-dispatch wall seconds in
``stats``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.chunk_attn import KERNEL_MODES
from repro_torch.models import transformer

from .cache import RingPagedKVCache
from .sampling import SamplingParams, sample_batch
from .scheduler import Request, Scheduler

__all__ = ["Engine", "EngineConfig", "Request", "SamplingParams"]

_COUNTERS = ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
             "generated_tokens", "requests_completed")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine construction knobs.

    slots: concurrent sequences served.
    max_len: per-slot cache window. For MRA attention this is the ring
      capacity (a multiple of the block size): at ``levels == 2`` prompts
      must fit and generation beyond it evicts the oldest background pages;
      at ``levels >= 3`` evicted pages collapse up the hierarchy and prompts
      of any length stream through. For dense attention it is a hard
      prompt + generation cap.
    chunk: prefill chunk size (tokens per slot per prefill dispatch),
      clamped to ``max_len`` and to the cache's ``chunk_cap`` (one block
      short of the window at ``levels >= 3``).
    default_sampling: sampler settings for requests submitted with
      ``sampling=None`` (None = greedy).
    kernel_mode: serving-kernel tile shape — "auto" (decode -> latency,
      prefill -> throughput), or "latency" / "throughput" for every
      dispatch. Token streams are the same in all three.
    spec_k / mesh / telemetry: speculative decoding, mesh serving and typed
      telemetry; not ported yet — any other value than the default raises.
    """

    slots: int = 4
    max_len: int = 512
    chunk: int = 32
    default_sampling: Optional[SamplingParams] = None
    kernel_mode: str = "auto"
    spec_k: int = 0
    mesh: Optional[object] = None
    telemetry: bool = False

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


class Engine:
    """Batched request server over ``config.slots`` concurrent sequences.

    ``Engine(cfg, params, EngineConfig(...), device=None)``: ``params``
    from ``models.params.init_params`` / ``params_from_jax`` on the same
    device; the device defaults to ``cuda`` and raises without one unless
    ``device="cpu"`` is passed.
    """

    def __init__(self, cfg: ModelConfig, params,
                 config: Optional[EngineConfig] = None, *, device=None):
        config = config or EngineConfig()
        if config.kernel_mode not in KERNEL_MODES:
            raise ValueError(f"EngineConfig.kernel_mode must be one of "
                             f"{KERNEL_MODES}, got {config.kernel_mode!r}")
        for name, later in (("spec_k", "speculative decoding"),
                            ("mesh", "distributed serving"),
                            ("telemetry", "serving telemetry")):
            default = EngineConfig.__dataclass_fields__[name].default
            if getattr(config, name) != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(config, name)!r}: {later} "
                    "is not ported yet")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} does not serve in the port yet")
        self.device = resolve_device(device)
        tok = params["embed"]["tok"]
        if tok.device.type != self.device.type:
            raise ValueError(
                f"params are on {tok.device}, the engine runs on {self.device}")
        if config.kernel_mode != "auto":
            cfg = cfg.replace(attn_kernel_mode=config.kernel_mode)
        self.config = config
        self.cfg = cfg
        self.params = params
        self.slots = config.slots
        self.max_len = config.max_len
        self.kv = RingPagedKVCache(cfg, self.slots, self.max_len,
                                   device=self.device)
        self.chunk = min(config.chunk, self.max_len)
        if self.kv.chunk_cap is not None:
            self.chunk = min(self.chunk, self.kv.chunk_cap)
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the counters and the per-dispatch wall-second totals."""
        self.stats = {k: 0 for k in _COUNTERS}
        self.stats.update(prefill_seconds=0.0, decode_seconds=0.0)

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sync(self) -> None:
        """Wait for the device, so a dispatch's wall time is its own."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request]) -> List[Request]:
        """Serve ``requests`` to completion; returns them with ``out`` filled
        (completion order, which may differ from submission order)."""
        sched = Scheduler(self.slots, self.kv.capacity, self.chunk,
                          ring=self.kv.paged,
                          default_sampling=self.config.default_sampling)
        for r in requests:
            sched.submit(r)
        while sched.busy():
            self._iterate(sched)
        self.stats["requests_completed"] += len(sched.done)
        return sched.done

    # ------------------------------------------------------------------ #
    def _iterate(self, sched: Scheduler) -> None:
        newly = sched.admit()
        if newly:
            mask = np.zeros((self.slots,), bool)
            mask[newly] = True
            self.kv.reset_slots(mask)

        plan = sched.prefill_plan()
        if plan is not None:
            tokens, num_valid, finishing = plan
            t0 = time.perf_counter()
            logits, _ = transformer.prefill_chunk(
                self.params, self.cfg, self.kv.tree,
                self._tensor(tokens, torch.int64),
                self._tensor(num_valid, torch.int32))
            first = None
            if finishing:
                first = sample_batch(logits, *sched.sampler_arrays(),
                                     vocab=self.cfg.vocab).cpu().numpy()
            self._sync()
            self.stats["prefill_seconds"] += time.perf_counter() - t0
            self.stats["prefill_dispatches"] += 1
            self.stats["prefill_tokens"] += int(num_valid.sum())
            for s in finishing:
                sched.on_sampled(s, first[s])
            self.stats["generated_tokens"] += len(finishing)

        active = sched.decode_mask()
        if active.any():
            self._plain_decode(sched, active)

    def _plain_decode(self, sched: Scheduler, active: np.ndarray) -> None:
        """One decode_step + sample dispatch for the ``active`` slots."""
        feed = sched.feed_tokens()
        t0 = time.perf_counter()
        logits, _ = transformer.decode_step(
            self.params, self.cfg, self.kv.tree, self._tensor(feed, torch.int64),
            active=self._tensor(active, torch.bool))
        nxt = sample_batch(logits, *sched.sampler_arrays(),
                           vocab=self.cfg.vocab).cpu().numpy()
        self.stats["decode_seconds"] += time.perf_counter() - t0
        self.stats["decode_dispatches"] += 1
        for s in np.flatnonzero(active):
            sched.on_sampled(int(s), nxt[s])
        self.stats["generated_tokens"] += int(active.sum())
