#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch/``) and drives the port's serving path on the card:

  1. device and build — the card's name and power limit, build seconds;
  2. kernel vs plain version — every CUDA kernel against its plain PyTorch
     twin on the same CUDA tensors, at the main path's shapes and at the
     smoke config's, over decode/chunk widths, bf16/int8 caches, MRA-2 /
     MRA-2-s and dense/ring/ragged layouts (atol 2e-5 / rtol 1e-5 on rows
     whose top-m selection is no near tie; near ties under 1% of rows);
  3. kernel timing at the main path's shapes, beside its bound and the
     plain version's time;
  4. the engine at full width — qwen3-1.7b, random weights from a seed, bf16
     activations, four greedy requests that run past the 4096-token ring —
     with the kernel's launches counted over exactly that run; then a
     torch.profiler breakdown of its decode and prefill dispatches;
  5. engine parity — the same engine with the plain version substituted for
     the kernel (in this script only): identical greedy streams at the smoke
     size, identical first tokens at full width (4 layers, fp32).

One JSON line per phase; then the card line from nvidia-smi, the kernels
line and, last, ``{"ok": true, "device": {...}}``. Any failed phase raises,
so the run exits non-zero and prints no result. Without a CUDA device it
exits 2 before doing anything.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
ATOL, RTOL, TIE = 2e-5, 1e-5, 1e-4
MAIN = dict(B=4, Hkv=8, G=2, D=128, b=128, nb=32, m=16)  # qwen3-1.7b serving
SMOKE = dict(B=4, Hkv=2, G=2, D=16, b=16, nb=4, m=2)     # its smoke config
WIDTHS = ((1, "latency"), (128, "throughput"), (5, "throughput"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------- #
# kernel inputs, selection margins and bounds
# --------------------------------------------------------------------------- #
def kernel_case(torch, tmd, seed, sh, C, layout, dtype):
    """(pre, k, v, q_pos, ks, vs) for one comparison, numpy from ``seed``.

    Keys carry a random per-page offset so coarse scores spread like real
    attention. layout: dense (full slots) | ring (a 1.5x-capacity stream
    through the ring) | ragged (random lengths, slot 0 empty).
    """
    from repro_torch.core.mra import MraConfig

    r = np.random.default_rng(seed)
    B, Hkv, G, D, b, nb = (sh[k] for k in ("B", "Hkv", "G", "D", "b", "nb"))
    S = nb * b
    k = r.standard_normal((B, Hkv, S, D), np.float32) + np.repeat(
        r.standard_normal((B, Hkv, nb, D), np.float32), b, axis=2)
    v = r.standard_normal((B, Hkv, S, D), np.float32)
    q = r.standard_normal((B, Hkv * G, C, D), np.float32)
    pb = np.tile(np.arange(nb, dtype=np.int32), (B, 1))
    if layout == "ring":
        lengths = np.full((B,), S + S // 2)
        pb = np.roll(pb + nb // 2, nb // 2, axis=1).astype(np.int32)
    elif layout == "ragged":
        lengths = np.concatenate([[0], r.integers(1, S + 1, B - 1)])
    else:
        lengths = np.full((B,), S)
    q_pos = np.maximum(lengths[:, None] - C, 0) + np.arange(C)
    cu = DEVICE
    k, v = torch.from_numpy(k).to(cu), torch.from_numpy(v).to(cu)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=cu)
    pb = torch.from_numpy(pb).to(cu)
    ks = vs = None
    if dtype == "int8":
        k, ks = tmd.quantize_kv(k)
        v, vs = tmd.quantize_kv(v)
        kf, vf = k.float() * ks[..., None], v.float() * vs[..., None]
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        kf, vf = k.float(), v.float()
    mask = tmd.paged_position_mask(lengths, pb, S, b).float()[:, None, :, None]
    pyr = tmd.PyramidState((kf * mask).reshape(B, Hkv, nb, b, D).sum(3),
                           (vf * mask).reshape(B, Hkv, nb, b, D).sum(3))
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=cu)
    pre = tmd._chunk_prelude(torch.from_numpy(q).to(cu), k, v, lengths, q_pos,
                             MraConfig(block_size=b), sh["m"], pyr, pb)
    return pre, k, v, q_pos, ks, vs


def selection_stats(torch, tmd, pre, q_pos, m):
    """Per-row selection margin (gap between the m-th and (m+1)-th allowed
    score), the (B, Hkv, nb) selection union, and the (row, key) pairs the
    exact term attends — all from the plain version's fp32 scores."""
    sel = tmd._select_pages(pre, q_pos, m)
    scores = torch.where(sel.allowed, sel.coarse_m + 2e9 * sel.ownl, -torch.inf)
    top = torch.sort(scores, dim=-1, descending=True).values
    if top.shape[-1] > m:
        gap = top[..., m - 1] - top[..., m]
        margin = torch.where(torch.isfinite(gap), gap, torch.inf)
    else:
        margin = torch.full(top.shape[:-1], torch.inf, device=top.device)
    grid = torch.zeros(sel.coarse_m.shape, dtype=torch.bool,
                       device=top.device).scatter_(-1, sel.y_idx, sel.sel_ok)
    union = grid.any(3).any(2)  # (B, Hkv, nb)
    b = pre.block_size
    j = torch.arange(b, device=top.device)
    pos = pre.pb[:, None, None, None, :, None] * b + j  # (B,1,1,1,nb,b)
    ok = (pos >= 0) & (pos <= q_pos[:, None, None, :, None, None])
    pairs = int((grid[..., None] & ok).sum())
    return margin, union, pairs


def bound(pre, k, q_pos, ks, union, pairs):
    """Least time for this call: bytes it must move (each input read once,
    the output written once) over HBM bandwidth vs fp32 operations over
    the fp32 rate; returns (ms, "bytes" | "operations", bytes, flops)."""
    B, Hkv, G, C, D = pre.qg.shape
    b, nb = pre.block_size, pre.pb.shape[1]
    page = b * D * k.element_size() + (b * 4 if ks is not None else 0)
    rows = B * Hkv * G * C
    nbytes = (2 * int(union.sum()) * page          # selected K/V pages (+scales)
              + 2 * B * Hkv * nb * D * 4           # page means k_ds, v_ds
              + 2 * B * nb * 4                     # counts, page table
              + rows * D * 4 + B * C * 4           # queries, positions
              + rows * D * 4)                      # output
    flops = (2 * 2 * rows * nb * D                 # coarse scores + background
             + 2 * 2 * pairs * D)                  # exact scores + P.V
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def phase_device(torch):
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()}})
    return smi


def phase_kernel_vs_plain(torch, tmd, chunk_attn):
    worst, ties, rows, n = 0.0, 0, 0, 0
    for (name, sh), (C, mode) in itertools.product(
            (("main", MAIN), ("smoke", SMOKE)), WIDTHS):
        for layout, dtype, variant in itertools.product(
                ("dense", "ring", "ragged"), ("bf16", "int8"),
                ("full", "sparse")):
            n += 1
            pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + n, sh, C,
                                                   layout, dtype)
            kw = dict(m=sh["m"], k_scale=ks, v_scale=vs,
                      include_bg=variant == "full", mode=mode)
            got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            torch.cuda.synchronize()
            margin, _, _ = selection_stats(torch, tmd, pre, q_pos, sh["m"])
            tie = (margin < TIE).reshape(got.shape[:3])[..., None]
            close = torch.isclose(got, ref, atol=ATOL, rtol=RTOL) | tie
            err = float(torch.where(tie, 0.0, (got - ref).abs()).max())
            if not bool(close.all()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"chunk_attn kernel != plain version: {name} C={C} {mode} "
                    f"{layout} {dtype} {variant}: max |err| {err}")
            worst = max(worst, err)
            ties += int(tie.sum())
            rows += tie.numel()
    emit({"phase": "kernel_vs_plain", "kernel": "chunk_attn", "cases": n,
          "atol": ATOL, "rtol": RTOL, "max_abs_err": worst,
          "near_tie_rows": ties, "rows": rows, "tie_margin": TIE})
    if ties > 0.01 * rows:
        raise AssertionError(f"{ties} near-tie rows of {rows} exceed 1%")
    return worst


def phase_timing(torch, tmd, chunk_attn):
    out = {}
    for label, C, mode in (("decode", 1, "latency"),
                           ("chunk128", 128, "throughput")):
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, MAIN, C,
                                               "dense", "bf16")
        kw = dict(m=MAIN["m"], include_bg=True, mode=mode)
        ms = time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
            pre, k, v, q_pos, **kw), 200)
        plain_ms = time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
            pre, k, v, q_pos, **kw), 20)
        _, union, pairs = selection_stats(torch, tmd, pre, q_pos, MAIN["m"])
        bound_ms, by, nbytes, flops = bound(pre, k, q_pos, ks, union, pairs)
        out[label] = {"C": C, "mode": mode, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes,
                      "flops": flops, "union_pages": int(union.sum())}
    emit({"phase": "kernel_timing", "kernel": "chunk_attn", "shape": MAIN,
          "cache": "bf16", "layout": "dense 4096-token slots", **out})
    return out


def _requests(Request, lengths, new_tokens, vocab):
    r = np.random.default_rng(SEED)
    return [Request(prompt=r.integers(0, vocab, n), max_new_tokens=new_tokens)
            for n in lengths]


def phase_engine_full_width(torch, chunk_attn):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(slots=4, max_len=4096, chunk=128),
                 device=DEVICE)
    reqs = _requests(Request, (3968, 2500, 1200, 300), 192, cfg.vocab)
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
    orig = (transformer.prefill_chunk, transformer.decode_step)

    def finite(fn):  # counts non-finite logits on the device, no sync
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(transformer, "prefill_chunk", finite(orig[0])), \
            mock.patch.object(transformer, "decode_step", finite(orig[1])):
        chunk_attn.chunk_attention_kernel.launches = 0
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = chunk_attn.chunk_attention_kernel.launches
    st = eng.stats
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    outs = [r.out for r in done]
    emit({"phase": "engine_full_width", "arch": cfg.name,
          "layers": cfg.num_layers, "activ_dtype": cfg.activ_dtype,
          "param_dtype": cfg.param_dtype, "slots": 4, "max_len": 4096,
          "chunk": 128, "prompts": [3968, 2500, 1200, 300], "new_tokens": 192,
          "wall_s": wall, "generated_tokens": st["generated_tokens"],
          "tok_per_s": st["generated_tokens"] / wall,
          "prefill_tokens": st["prefill_tokens"],
          "prefill_dispatches": st["prefill_dispatches"],
          "prefill_s": st["prefill_seconds"],
          "decode_dispatches": st["decode_dispatches"],
          "decode_s": st["decode_seconds"],
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "kernel_launches": launches,
          "evicted_tokens": float(eng.kv.occupancy()["tokens_evicted"])})
    if launches != cfg.num_layers * dispatches:
        raise AssertionError(f"{launches} kernel launches != {cfg.num_layers} "
                             f"x {dispatches} dispatches")
    if int(bad) != 0:
        raise AssertionError(f"{int(bad)} non-finite logits")
    if any(len(o) != 192 or int(o.min()) < 0 or int(o.max()) >= cfg.vocab
           for o in outs):
        raise AssertionError("a stream is short or holds an out-of-vocab token")
    return launches, eng


def _profile(torch, fn, steps):
    """Wall ms per call without the profiler, then torch.profiler over the
    same calls: device ms per call, busy share, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    rows = []  # kernels only: an operator's row repeats its kernels' time
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((e.key, us / 1e3 / steps))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "chunk_attn_ms": sum(ms for k, ms in rows if "chunk_attn" in k),
            "top": [[k[:100], ms] for k, ms in rows[:10]]}


def phase_profile(torch, eng):
    """Where a full-width dispatch's time goes, on the engine's own cache
    after its run: decode waves of 4 slots, and C = 128 prefill chunks."""
    from repro_torch.models import transformer
    from repro_torch.serve.sampling import greedy_batch

    B = eng.slots
    toks = torch.arange(1, B + 1, device=DEVICE)
    active = torch.ones(B, dtype=torch.bool, device=DEVICE)
    chunk = (torch.arange(1, B * 128 + 1, device=DEVICE)
             % eng.cfg.vocab).reshape(B, 128)
    nv = torch.full((B,), 128, dtype=torch.int32, device=DEVICE)

    def decode():
        logits, _ = transformer.decode_step(eng.params, eng.cfg, eng.kv.tree,
                                            toks, active=active)
        greedy_batch(logits, vocab=eng.cfg.vocab).cpu()

    def prefill():
        transformer.prefill_chunk(eng.params, eng.cfg, eng.kv.tree, chunk, nv)

    emit({"phase": "profile", "note": "ms per dispatch; device_ms = summed "
          "kernel time from torch.profiler; busy_share = device_ms / wall_ms",
          "decode_step": _profile(torch, decode, 10),
          "prefill_chunk_128": _profile(torch, prefill, 3)})


def _streams(torch, chunk_attn, cfg, params, ecfg, reqs, plain):
    from repro_torch.serve import Engine

    def ref(pre, k_cache, v_cache, q_pos, **kw):
        return chunk_attn.chunk_attention_ref(pre, k_cache, v_cache, q_pos, **kw)

    chunk_attn.chunk_attention_kernel.launches = 0
    if plain:
        with mock.patch.object(chunk_attn, "chunk_attention_kernel", ref):
            done = Engine(cfg, params, ecfg, device=DEVICE).run(reqs)
    else:
        done = Engine(cfg, params, ecfg, device=DEVICE).run(reqs)
    launches = chunk_attn.chunk_attention_kernel.launches
    if (launches == 0) != plain:
        raise AssertionError(f"plain={plain} run made {launches} launches")
    return {len(r.prompt): np.asarray(r.out) for r in done}


def phase_engine_parity(torch, chunk_attn):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.serve import EngineConfig, Request

    result = {}
    small = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
    params = init_params(small, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=3, max_len=64, chunk=8)
    streams = [_streams(torch, chunk_attn, small, params, ecfg, _requests(
        Request, (19, 3, 10, 40, 50), 60, small.vocab), plain)
        for plain in (False, True)]
    same = all(np.array_equal(streams[0][n], streams[1][n]) for n in streams[0])
    result["smoke"] = {"identical_streams": same, "requests": len(streams[0])}
    if not same:
        raise AssertionError("smoke-size greedy streams differ kernel vs plain")
    del params

    full4 = get_config("qwen3-1.7b", num_layers=4, activ_dtype="float32")
    params = init_params(full4, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=4, max_len=4096, chunk=128)
    streams = [_streams(torch, chunk_attn, full4, params, ecfg, _requests(
        Request, (3968, 2500, 1200, 300), 16, full4.vocab), plain)
        for plain in (False, True)]
    first = all(streams[0][n][0] == streams[1][n][0] for n in streams[0])
    agree = np.mean([np.mean(streams[0][n] == streams[1][n])
                     for n in streams[0]])
    result["full_width_4_layers"] = {"first_tokens_match": bool(first),
                                     "token_agreement": float(agree)}
    emit({"phase": "engine_parity", **result})
    if not first:
        raise AssertionError("full-width first tokens differ kernel vs plain")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import mra_decode as tmd
    from repro_torch.kernels import chunk_attn

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device(torch)
    max_err = phase_kernel_vs_plain(torch, tmd, chunk_attn)
    timing = phase_timing(torch, tmd, chunk_attn)
    launches, eng = phase_engine_full_width(torch, chunk_attn)
    phase_profile(torch, eng)
    del eng
    phase_engine_parity(torch, chunk_attn)
    dec = timing["decode"]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "chunk_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_attn.cu",
        "replaces": "src/repro/kernels/chunk_attn.py:93",
        "launches": launches, "max_abs_err": max_err,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None, "shape": "decode C=1 (latency); chunk128 below",
        "chunk128": {k: timing["chunk128"][k] for k in
                     ("ms", "plain_ms", "bound_ms", "bound_by")}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
