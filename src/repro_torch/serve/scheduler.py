"""Continuous-batching scheduler: admission + per-slot state machines.

Port of ``repro/serve/scheduler.py`` (host-side numpy). Each slot runs

    FREE -> PREFILL -> DECODE -> FREE

with ragged per-slot progress: slots prefill different prompts in shared
chunked dispatches, decode at different lengths in shared decode
dispatches, and finish/readmit independently. The scheduler only plans;
device state lives in the cache backend and numerics in the model
functions, so planning order can never change a request's tokens. It
stamps each request's lifecycle through the engine's telemetry
(``serve/telemetry.py``) and delivers a speculative round's ragged
emission (``on_spec_tokens``).
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import List, Optional

import numpy as np

from .sampling import SamplingParams
from .telemetry import Telemetry


@dataclasses.dataclass
class Request:
    """One generation request.

    prompt: (S,) int array of prompt token ids (S may be 0).
    max_new_tokens: number of tokens to sample.
    sampling: per-request sampler settings; None = the engine's
      ``EngineConfig.default_sampling`` (greedy when that is unset too),
      resolved at submit.
    out: filled by the engine — (max_new_tokens,) int32 sampled tokens
      (empty for degenerate requests: empty prompt or max_new_tokens <= 0).
    spec_accepted: drafted tokens of this request that verification
      accepted (speculative serving; DESIGN.md §10).
    trace: lifecycle stamps (``telemetry.RequestTrace``); None with
      telemetry disabled.
    """

    prompt: np.ndarray
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None
    out: Optional[np.ndarray] = None
    spec_accepted: int = 0
    trace: Optional[object] = None


class SlotState(enum.Enum):
    FREE = "free"
    PREFILL = "prefill"
    DECODE = "decode"


@dataclasses.dataclass
class Slot:
    state: SlotState = SlotState.FREE
    req: Optional[Request] = None
    fed: int = 0        # prompt tokens written to the cache so far
    generated: int = 0  # tokens sampled so far (== sampler step index)
    token: int = 0      # next token to feed to decode (last sampled)
    out: List[int] = dataclasses.field(default_factory=list)


class Scheduler:
    """Admission queue + slot state machines for the serving engine.

    capacity: cache window per slot (tokens). Prompts longer than it are
      rejected at submit; when ``ring`` is False (dense cache: non-MRA
      attention kinds) prompt + max_new_tokens must also fit — a ring cache
      instead evicts its oldest background pages.
    """

    def __init__(self, slots: int, capacity: Optional[int], chunk: int, *,
                 ring: bool = True,
                 default_sampling: Optional[SamplingParams] = None,
                 telemetry: Optional[Telemetry] = None):
        if chunk < 1 or (capacity is not None and capacity < 1):
            raise ValueError(f"chunk {chunk} and capacity {capacity} must be >= 1")
        self.capacity = capacity
        self.chunk = chunk if capacity is None else min(chunk, capacity)
        self.ring = ring
        self.default_sampling = default_sampling
        self.slots = [Slot() for _ in range(slots)]
        self.pending: deque = deque()
        self.done: List[Request] = []
        # lifecycle stamping; None (direct construction) is the no-op
        self.telemetry = telemetry or Telemetry(enabled=False)

    # ---- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        plen = int(len(req.prompt))
        if req.sampling is None:
            req.sampling = self.default_sampling or SamplingParams()
        self.telemetry.on_submit(req)
        if self.capacity is not None:
            if plen > self.capacity:
                raise ValueError(
                    f"prompt of {plen} tokens exceeds the engine's per-slot "
                    f"capacity of {self.capacity}")
            if not self.ring and plen + req.max_new_tokens > self.capacity:
                raise ValueError(
                    f"prompt {plen} + max_new_tokens {req.max_new_tokens} "
                    f"exceeds the dense cache capacity {self.capacity} "
                    "(only the MRA ring-paged cache evicts)")
        if plen == 0 or req.max_new_tokens <= 0:
            # degenerate: nothing to condition on / nothing to sample — done
            # without occupying a slot or issuing a spurious decode step
            req.out = np.array([], np.int32)
            self.done.append(req)
            self.telemetry.on_complete(req)
            return
        self.pending.append(req)

    def admit(self) -> List[int]:
        """Bind pending requests to free slots; returns newly admitted ids."""
        newly = []
        for s, slot in enumerate(self.slots):
            if slot.state is SlotState.FREE and self.pending:
                req = self.pending.popleft()
                self.slots[s] = Slot(state=SlotState.PREFILL, req=req)
                self.telemetry.on_admit(req, s)
                newly.append(s)
        return newly

    # ---- prefill planning --------------------------------------------------
    def prefill_plan(self):
        """Next chunk of prompt tokens per prefilling slot, or None.

        Returns (tokens (n_slots, chunk) int32, num_valid (n_slots,) int32,
        finishing list of slot ids whose prompt completes with this chunk).
        Commits the plan: callers must execute it exactly once.
        """
        if not any(s.state is SlotState.PREFILL for s in self.slots):
            return None
        n = len(self.slots)
        tokens = np.zeros((n, self.chunk), np.int32)
        num_valid = np.zeros((n,), np.int32)
        finishing = []
        for s, slot in enumerate(self.slots):
            if slot.state is not SlotState.PREFILL:
                continue
            prompt = np.asarray(slot.req.prompt, np.int32)
            take = min(self.chunk, len(prompt) - slot.fed)
            tokens[s, :take] = prompt[slot.fed : slot.fed + take]
            num_valid[s] = take
            slot.fed += take
            if slot.fed == len(prompt):
                slot.state = SlotState.DECODE
                finishing.append(s)
        return tokens, num_valid, finishing

    # ---- decode planning ---------------------------------------------------
    def decode_mask(self) -> np.ndarray:
        """(n_slots,) bool — slots with a token to feed this step."""
        return np.array(
            [s.state is SlotState.DECODE and s.generated > 0 for s in self.slots],
            bool)

    def any_sampling(self, slots=None) -> bool:
        """True when any of ``slots`` (default: every DECODE slot) samples
        (temperature > 0); a sampling request still prefilling must not
        send greedy decode slots down the sampling path."""
        if slots is None:
            slots = [s for s, slot in enumerate(self.slots)
                     if slot.state is SlotState.DECODE]
        return any(self.slots[s].req is not None
                   and self.slots[s].req.sampling.temperature > 0.0
                   for s in slots)

    def feed_tokens(self) -> np.ndarray:
        """(n_slots,) int32 token each slot feeds next (garbage if inactive)."""
        return np.array([s.token for s in self.slots], np.int32)

    def sampler_arrays(self):
        """Per-slot sampler params: (temperature, top_k, top_p, seed, step)."""
        n = len(self.slots)
        temp = np.zeros((n,), np.float32)
        top_k = np.zeros((n,), np.int32)
        top_p = np.ones((n,), np.float32)
        seed = np.zeros((n,), np.int64)
        step = np.zeros((n,), np.int64)
        for s, slot in enumerate(self.slots):
            if slot.req is None:
                continue
            sp = slot.req.sampling
            temp[s], top_k[s], top_p[s] = sp.temperature, sp.top_k, sp.top_p
            seed[s], step[s] = sp.seed, slot.generated
        return temp, top_k, top_p, seed, step

    # ---- progress ----------------------------------------------------------
    def _decoding(self, s: int) -> Slot:
        slot = self.slots[s]
        if slot.state is not SlotState.DECODE or slot.req is None:
            raise RuntimeError(f"slot {s} is {slot.state}, not decoding")
        return slot

    def on_spec_tokens(self, s: int, tokens, n_accepted: int) -> int:
        """Deliver a speculative round's emission to slot ``s``.

        ``tokens`` are the round's tokens for this slot (accepted drafts,
        then the correction or bonus token), ``n_accepted`` the accepted
        drafts among them. Delivery stops when the request completes: the
        surplus is dropped (the rewind already trimmed the cache, and a
        freed slot is reset on readmission). Returns the delivered count.
        """
        slot = self._decoding(s)
        slot.req.spec_accepted += int(n_accepted)
        self.telemetry.on_spec_accept(slot.req, s, int(n_accepted))
        delivered = 0
        for t in tokens:
            delivered += 1
            if self.on_sampled(s, int(t)) is not None:
                break
        return delivered

    def on_sampled(self, s: int, token: int) -> Optional[Request]:
        """Record a sampled token for slot ``s``; returns the request when done."""
        slot = self._decoding(s)
        slot.out.append(int(token))
        slot.token = int(token)
        slot.generated += 1
        self.telemetry.on_token(slot.req)
        if slot.generated >= slot.req.max_new_tokens:
            req = slot.req
            req.out = np.array(slot.out, np.int32)
            self.done.append(req)
            self.slots[s] = Slot()
            self.telemetry.on_complete(req)
            return req
        return None

    def busy(self) -> bool:
        return bool(self.pending) or any(
            s.state is not SlotState.FREE for s in self.slots)
