"""The traced run: torch.profiler over the window, and the launches of
the kernels whose rooflines the benchmark reads.

``Recorder`` wraps the program's kernel entry points for the window: it
keeps each call's inputs that the work counts need (small clones on the
device, no synchronisation) and hands the call on unchanged. ``Trace``
runs the profiler (device activity only) and sums its raw events in one
pass (the method of the program's ``chip_smoke.py`` profiles): the device
time of each kernel by name, the union of the device intervals (busy),
and the longest idle gaps, each named by the kernels on either side.
"""
from __future__ import annotations

import contextlib
import time

import torch

from . import work


class Recorder:
    """Per kernel name, the recorded calls of the window."""

    def __init__(self):
        self.calls = {"chunk_attn": [], "bsa_fwd": [], "bsa_bwd_dq": [],
                      "bsa_bwd_dkv": []}
        self._undo = []

    def _patch(self, module, name, wrapper):
        orig = getattr(module, name)
        setattr(module, name, wrapper(orig))
        self._undo.append((module, name, orig))

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.kernels import block_sparse_attn as bsa
        from repro_torch.kernels import chunk_attn

        def chunk(orig):
            def call(pre, k_cache, v_cache, q_pos, *, m, **kw):
                B, Hkv, G, C, D = pre.qg.shape
                self.calls["chunk_attn"].append(dict(
                    q_pos=q_pos.clone(), counts=pre.counts.clone(),
                    Hkv=Hkv, G=G, D=D, b=pre.block_size,
                    m=m, elem=k_cache.element_size()))
                return orig(pre, k_cache, v_cache, q_pos, m=m, **kw)
            call.__dict__ = orig.__dict__  # the launch counters stay shared
            return call

        def bsa_kernel(name):
            def wrap(orig):
                def call(q, k, v, *args, **kw):
                    pairs = args[1] if name == "bsa_fwd" else args[3]
                    self.calls[name].append(dict(
                        flags=pairs.flags.clone(), BHG=q.shape[0],
                        BHKV=k.shape[0], n=q.shape[1], d=q.shape[2],
                        b=kw["block_size"], elem=q.element_size()))
                    return orig(q, k, v, *args, **kw)
                call.__dict__ = orig.__dict__
                return call
            return wrap

        self._patch(chunk_attn, "chunk_attention_kernel", chunk)
        for name in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv"):
            self._patch(bsa, name, bsa_kernel(name))
        try:
            yield self
        finally:
            for module, name, orig in reversed(self._undo):
                setattr(module, name, orig)
            self._undo.clear()

    def least_s(self, name: str):
        """Summed least time of the recorded calls, or None without any."""
        calls = self.calls[name]
        if not calls:
            return None
        total = 0.0
        for c in calls:
            if name == "chunk_attn":
                flops, nbytes = work.chunk_call(
                    c["q_pos"], c["counts"], Hkv=c["Hkv"],
                    G=c["G"], D=c["D"], b=c["b"], m=c["m"], elem=c["elem"])
                total += work.least_s(float(flops), float(nbytes))
            else:
                flops, nbytes = work.bsa_call(
                    name, c["flags"], BHG=c["BHG"], BHKV=c["BHKV"],
                    n=c["n"], d=c["d"], b=c["b"], elem=c["elem"])
                total += work.least_s(float(flops), nbytes)
        return total


class Trace:
    """torch.profiler over the window; ``summary()`` after it closed."""

    def __init__(self):
        self.prof = None
        self.wall_s = None

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield self
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - t0
        self.prof = prof

    def summary(self) -> dict:
        """{"kernel_s": {name: s}, "busy_s", "window_s", "device_ops":
        top 10 [name, s], "idle_gaps": top 10 [name, s]}. Device events
        that mirror a host annotation (the engine's ``serve.*`` dispatch
        ranges) are not kernels and are left out."""
        from torch.autograd import DeviceType

        names, kernel_ns, spans = {}, {}, []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            raw = e.name()
            name = names.get(raw)
            if name is None:
                name = names[raw] = (torch._C._demangle(raw)
                                     if len(raw) > 1 else raw)
            if name.startswith(("serve.", "ProfilerStep")):
                continue
            t0, ns = e.start_ns(), e.duration_ns()
            kernel_ns[name] = kernel_ns.get(name, 0) + ns
            spans.append((t0, t0 + ns, name))
        spans.sort()
        busy, gaps = 0, []
        cur0 = cur1 = None
        last = None
        for a, b, name in spans:
            if cur1 is None:
                cur0, cur1, last = a, b, name
                continue
            if a > cur1:
                busy += cur1 - cur0
                gaps.append((a - cur1, f"after {_short(last)} "
                                       f"before {_short(name)}"))
                cur0, cur1 = a, b
            elif b > cur1:
                cur1 = b
            if b >= cur1:
                last = name
        if cur1 is not None:
            busy += cur1 - cur0
        merged = {}
        for ns, label in gaps:
            merged[label] = merged.get(label, 0) + ns
        top_ops = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:10]
        top_gaps = sorted(merged.items(), key=lambda kv: -kv[1])[:10]
        return {"kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
                "busy_s": busy / 1e9, "window_s": self.wall_s,
                "device_ops": [[_short(k), v / 1e9] for k, v in top_ops],
                "idle_gaps": [[k, v / 1e9] for k, v in top_gaps]}


def _short(name: str) -> str:
    """A kernel's name without its namespaces' anonymous part, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        i = name.find(sep)
        if i > 0:
            name = name[:i]
    return name.strip().split(" ")[-1][:80]


def device_s(summary: dict, *prefixes: str) -> float:
    """Device seconds of the kernels whose short names start with one of
    ``prefixes``."""
    return sum(s for k, s in summary["kernel_s"].items()
               if _short(k).startswith(prefixes))
