"""Serving engine: ragged continuous batching with chunked prefill + sampling.

Port of ``repro/serve/engine.py`` (DESIGN.md §9). Per engine iteration:

  1. admission — pending requests bind to FREE slots; the slot's cache rows
     are reset bit-exactly (``CacheBackend.reset_slots``).
  2. chunked prefill — ONE ``prefill_chunk`` dispatch advances every
     PREFILL slot by up to ``chunk`` prompt tokens (ragged ``num_valid``).
     Slots whose prompt completes sample their first token from the
     chunk's last-position logits.
  3. decode — ONE ``decode_step`` + sampling dispatch advances every DECODE
     slot (active-masked: other slots' state is untouched bit-for-bit).
     With ``spec_k > 0`` the wave runs a resolution-speculative round
     instead (``serve/speculative.py``, DESIGN.md §10): K coarse-pyramid
     drafts + one chunked full-MRA verify emit up to K + 1 tokens a slot,
     with greedy streams identical to plain decoding; slots whose round
     would straddle a ring-eviction boundary take a plain wave.

The model comes from the registry (``models/registry.py``) and the cache
from the model's per-layer cache kinds (``serve/cache.make_cache``): the
transformer families serve over the ring-paged KV cache, where on a card
every layer of every dispatch runs MRA chunk/decode attention through the
CUDA kernel (``kernels/chunk_attn.py``); rwkv6 over its recurrent state,
which has no admission capacity (a stream may run past ``max_len``) and no
speculation; recurrentgemma over its window ring + RG-LRU state (the same,
with the chunk clamped to the window). Observability
(``serve/telemetry.py``, DESIGN.md §13): the engine's ``Telemetry`` declares
its metric set in ``reset_stats`` — typed counters, bounded histograms of
dispatch wall time and request latencies, occupancy gauges — and traces
each request's lifecycle; ``Engine.stats`` is a typed view over it.
``EngineConfig(telemetry=False)`` keeps only the counters.

Mesh serving (``EngineConfig.mesh``, a ``launch.mesh.Mesh``; every rank
of the process group builds the same engine and runs the same requests):
the parameters are cut to the rank's blocks (``shard_params``), the cache
tree is placed by its specs' axes (slots over "data"; kv heads, and
rwkv6's state heads, over "model"; the recurrentgemma window ring and
RG-LRU state over the slots only), so attention and the recurrences run on
the rank's block. Each model call takes the rank's slots (``kv.rows``)
and its logits, over the whole vocab, are gathered over every slot
(``kv.whole``), so sampling and the scheduler run alike on every rank and
every rank returns the same streams. The speculative engine (every
``draft_level``) rides through unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import mesh_utils
from repro_torch.distributed.sharding import shard_params
from repro_torch.kernels.chunk_attn import KERNEL_MODES
from repro_torch.models.registry import get_model

from .cache import make_cache
from .sampling import SamplingParams, sample_batch
from .scheduler import Request, Scheduler, SlotState
from .telemetry import StatsView, Telemetry

__all__ = ["Engine", "EngineConfig", "Request", "SamplingParams"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine construction knobs.

    slots: concurrent sequences served.
    max_len: per-slot cache window. For MRA attention this is the ring
      capacity (a multiple of the block size): at ``levels == 2`` prompts
      must fit and generation beyond it evicts the oldest background pages;
      at ``levels >= 3`` evicted pages collapse up the hierarchy and prompts
      of any length stream through. For dense attention it is a hard
      prompt + generation cap. The recurrent state does not grow with the
      stream: there it caps nothing but the chunk.
    chunk: prefill chunk size (tokens per slot per prefill dispatch),
      clamped to ``max_len`` and to the cache's ``chunk_cap`` (one block
      short of the window at ``levels >= 3``).
    default_sampling: sampler settings for requests submitted with
      ``sampling=None`` (None = greedy).
    kernel_mode: serving-kernel tile shape — "auto" (decode -> latency,
      prefill -> throughput), or "latency" / "throughput" for every
      dispatch. Token streams are the same in all three.
    spec_k: speculative draft length (0 = plain decode); needs an MRA
      attention kind and the ring-paged cache (a recurrent state raises),
      and ``spec_k + 1 <= max_len``.
    draft_level: background resolution of the drafts: 1 reads every
      page's mean; > 1 folds groups of 2^(draft_level-1) adjacent pages
      that are all background for a row through their mean (a dispatch
      raises where the cache's page count is not a multiple of that).
    mesh: a ``launch.mesh.Mesh`` for DP x TP serving (None: one device);
      ``params`` may be whole or the rank's blocks.
    telemetry: request-lifecycle tracing, latency histograms, occupancy
      gauges and profiler annotations (``serve/telemetry.py``). False keeps
      only the counters; token streams are the same either way.
    """

    slots: int = 4
    max_len: int = 512
    chunk: int = 32
    spec_k: int = 0
    draft_level: int = 1
    mesh: Optional[object] = None
    default_sampling: Optional[SamplingParams] = None
    kernel_mode: str = "auto"
    telemetry: bool = True

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
        if config.draft_level < 1:
            raise ValueError(f"EngineConfig.draft_level must be >= 1, got "
                             f"{config.draft_level}")
        self.model = get_model(cfg)  # raises for a family not ported
        self.device = resolve_device(device)
        tok = params["embed"]["tok"]
        if tok.device.type != self.device.type:
            raise ValueError(
                f"params are on {tok.device}, the engine runs on {self.device}")
        if config.kernel_mode != "auto":
            cfg = cfg.replace(attn_kernel_mode=config.kernel_mode)
        self.mesh = config.mesh
        self.config = config
        self.cfg = cfg
        self.slots = config.slots
        self.max_len = config.max_len
        self.kv = make_cache(cfg, self.model, self.slots, self.max_len,
                             device=self.device, mesh=self.mesh)
        self.params = (params if self.mesh is None
                       else shard_params(params, cfg, self.mesh))
        self.chunk = min(config.chunk, self.max_len)
        if self.kv.chunk_cap is not None:
            self.chunk = min(self.chunk, self.kv.chunk_cap)
        self.spec_k = config.spec_k
        self._spec = None
        if self.spec_k:
            from .speculative import SpecDecoder

            if self.spec_k + 1 > self.max_len:
                raise ValueError(f"spec_k {self.spec_k} + 1 exceeds the cache "
                                 f"window {self.max_len}")
            self._spec = SpecDecoder(cfg, self.spec_k, config.draft_level)
            if not self.kv.supports_spec:
                raise NotImplementedError(
                    "speculative decoding needs the ring-paged MRA cache; "
                    f"{type(self.kv).__name__} has no snapshot/rewind "
                    "(DESIGN.md §12)")
        self.reset_stats()

    def reset_stats(self) -> None:
        """Declare the engine's metric set anew, zeroed (DESIGN.md §13).

        The only place serving metrics come into existence: every counter a
        component writes — the engine's and the speculative keys
        ``SpecDecoder`` increments — is declared here, so a write to any
        other name raises ``UndeclaredMetric``. Dispatch wall time is in
        the ``prefill_chunk_seconds`` / ``decode_step_seconds`` (a whole
        decode wave) / ``draft_seconds`` / ``verify_seconds`` histograms,
        whose ``total`` is exact; each span ends after the device finished.
        """
        tel = Telemetry(enabled=self.config.telemetry, tags={
            "family": self.cfg.family,
            "cache": type(self.kv).__name__,
            "kernel_mode": self.config.kernel_mode,
        })
        m = tel.metrics
        m.declare_counter(
            "prefill_dispatches", "decode_dispatches", "prefill_tokens",
            "generated_tokens", "requests_completed",
            # speculative decoding (spec_k > 0; serve/speculative.py)
            "spec_rounds", "draft_dispatches", "verify_dispatches",
            "spec_drafted_tokens", "spec_accepted_tokens",
            "spec_emitted_tokens")
        # dispatch wall time + request-derived latencies, bounded reservoirs
        m.declare_histogram(
            "decode_step_seconds", "prefill_chunk_seconds", "draft_seconds",
            "verify_seconds", "ttft_seconds", "queue_wait_seconds",
            "prefill_seconds", "inter_token_seconds",
            "spec_accepted_per_round")
        # occupancy gauges, refreshed once per iteration; the cache's keys
        # (per-level ones at H >= 3 included) come from the backend itself
        m.declare_gauge(
            "queue_depth", "slots_free", "slots_prefill", "slots_decode",
            *("cache_" + k for k in self.kv.occupancy()))
        m.declare_series("spec_accept_by_slot")
        self.telemetry = tel

    @property
    def stats(self) -> StatsView:
        """Typed view over the telemetry registry: counters and gauges read
        as numbers, histograms as their reservoir lists; undeclared keys
        raise."""
        return StatsView(self.telemetry.metrics)

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
                          default_sampling=self.config.default_sampling,
                          telemetry=self.telemetry)
        for r in requests:
            sched.submit(r)
        with mesh_utils.use_mesh(self.mesh):
            while sched.busy():
                self._iterate(sched)
        self.telemetry.metrics.inc("requests_completed", len(sched.done))
        return sched.done

    # ------------------------------------------------------------------ #
    def _iterate(self, sched: Scheduler) -> None:
        tel = self.telemetry
        newly = sched.admit()
        if newly:
            mask = np.zeros((self.slots,), bool)
            mask[newly] = True
            self.kv.reset_slots(mask)

        plan = sched.prefill_plan()
        if plan is not None:
            tokens, num_valid, finishing = plan
            with tel.dispatch("prefill_chunk", hist="prefill_chunk_seconds",
                              tokens=int(num_valid.sum())):
                kv = self.kv
                logits, _ = self.model.prefill_chunk(
                    self.params, self.cfg, kv.tree,
                    kv.rows(self._tensor(tokens, torch.int64)),
                    kv.rows(self._tensor(num_valid, torch.int32)))
                logits = kv.whole(logits)
                first = None
                if finishing:
                    first = sample_batch(logits, *sched.sampler_arrays(),
                                         vocab=self.cfg.vocab).cpu().numpy()
                self._sync()
            tel.metrics.inc("prefill_dispatches")
            tel.metrics.inc("prefill_tokens", int(num_valid.sum()))
            for s in finishing:
                tel.on_prefill_done(sched.slots[s].req)
                sched.on_sampled(s, first[s])
            tel.metrics.inc("generated_tokens", len(finishing))

        active = sched.decode_mask()
        if active.any():
            t0 = tel.now() if tel.enabled else 0.0
            if self._spec is not None:
                spec_wave, plain_wave = self._spec.split_wave(self.kv, active)
                if spec_wave.any():
                    self._spec.round(self, sched, spec_wave)
                if plain_wave.any():
                    self._plain_decode(sched, plain_wave)
            else:
                self._plain_decode(sched, active)
            if tel.enabled:
                tel.metrics.observe("decode_step_seconds", tel.now() - t0)
        if tel.enabled:
            states = [s.state for s in sched.slots]
            tel.set_occupancy(
                {"queue_depth": len(sched.pending),
                 "slots_free": states.count(SlotState.FREE),
                 "slots_prefill": states.count(SlotState.PREFILL),
                 "slots_decode": states.count(SlotState.DECODE)},
                self.kv.occupancy())

    def _plain_decode(self, sched: Scheduler, active: np.ndarray) -> None:
        """One decode_step + sample dispatch for the ``active`` slots."""
        feed = sched.feed_tokens()
        with self.telemetry.dispatch("decode_step", slots=int(active.sum())):
            kv = self.kv
            logits, _ = self.model.decode_step(
                self.params, self.cfg, kv.tree,
                kv.rows(self._tensor(feed, torch.int64)),
                active=kv.rows(self._tensor(active, torch.bool)))
            logits = kv.whole(logits)
            nxt = sample_batch(logits, *sched.sampler_arrays(),
                               vocab=self.cfg.vocab).cpu().numpy()
        self.telemetry.metrics.inc("decode_dispatches")
        for s in np.flatnonzero(active):
            sched.on_sampled(int(s), nxt[s])
        self.telemetry.metrics.inc("generated_tokens", int(active.sum()))
