#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch/``, one nvcc per source, all at once) and drives the
port's serving path and its training path on the card:

  1. device and build — the card's name and power limit, build seconds,
     and ptxas' registers and spill bytes of every chunk_attn and bsa_*
     kernel (a bf16 bsa_fwd / bsa_bwd_dq / bsa_bwd_dkv instantiation that
     spills fails);
  2. kernel vs plain version — every CUDA kernel against its plain PyTorch
     twin on the same CUDA tensors, at the main path's shapes and at the
     smoke config's, over decode/chunk widths, bf16/int8 caches, MRA-2 /
     MRA-2-s and dense/ring/ragged layouts, plus decode at the serving
     (B = 4) and long-context (B = 2) shapes with the split count forced to
     1, 2 and the planned one (atol 2e-5 / rtol 1e-5 on rows whose top-m
     selection is no near tie; near ties under 1% of rows);
  3. kernel timing at the main path's shapes, beside its bound at the bf16
     tensor-core and the fp32 CUDA-core rate and the plain version's time,
     with the launch's split count, grid, shared memory, blocks per SM and
     the mean pages of a query tile's selection union;
  4. the engine at full width — qwen3-1.7b, random weights from a seed, bf16
     activations, four greedy requests that run past the 4096-token ring —
     with the kernel's launches (and the combine's, one per layer of every
     dispatch with a planned split) counted over exactly that run; then a
     torch.profiler breakdown of its decode and prefill dispatches;
  5. engine parity — the same engine with the plain version substituted for
     the kernel (in this script only): identical greedy streams at the smoke
     size, identical first tokens at full width (4 layers, fp32);
  6. block-sparse kernels vs plain — bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv
     against their plain twins on the same CUDA tensors, at the training
     path's shapes and the smoke config's, bf16 and fp32, G in {1, 2}, pairs
     from a real causal MRA-2 selection, and with padded keys, invalid pairs
     and an unvisited query tile; plus a hot key tile (every query block of
     a row also selects key block 0) at the main shapes and the padded head
     dim (d, b) = (12, 16); every kernel run twice, bit-identical;
  7. their timing at the main shapes beside the bounds, the plain versions
     and, as a yardstick of exact attention (not the same function), causal
     scaled_dot_product_attention forward + backward; for each of the three
     kernels also the grid, threads, shared memory, blocks per SM and the
     min/mean/max pairs of an output tile;
  8. training at full width — qwen3-1.7b, 28 layers, remat="full", seq 4096,
     batch 2, three steps of ``train()`` from random weights — with the
     kernels' launches counted over exactly that run, then a torch.profiler
     breakdown of one step;
  9. training parity — the plain versions substituted for the kernels (in
     this script only): losses over 3 steps at the smoke size, loss and
     grad norm of one step at full width (4 layers), all fp32;
 10. the chunk kernel's H-level program (``levels >= 3``: collapsed levels +
     tail folded into the background) against its plain twin on the same
     CUDA tensors: NU = 33 (H = 3) and 65 (H = 4) at the long-context
     slice's shapes, NU = 5 and 40 (three entry tiles) at the smoke shapes;
     C = 1, 512 and 5; bf16 / int8 caches; entries all live, some dead,
     all dead, tail only; ring windows and an empty one (slot 0: no live
     window key, live entries: not zero); MRA-2-s, where the view must not
     change the output; decode with the split count forced to 1, 2 and the
     planned one (same tolerance and near-tie rule as phase 2);
 11. its timing at the slice's shapes (decode and C = 512) beside the
     two-level program on the same window, both bounds, the plain version
     and the launch's split, grid, shared memory and occupancy;
 12. long-context serving at full width — qwen3-1.7b at ``levels=3``, 28
     layers, bf16 activations, ``EngineConfig(slots=2, max_len=4096,
     chunk=512)``, a 65536-token and a 6000-token greedy prompt — with
     the H-level program's launches counted over exactly that run (and
     none of the two-level one; the combine's as in phase 4), the occupancy
     gauges and exact per-slot token conservation, then a torch.profiler
     breakdown of its prefill and decode dispatches;
 13. H = 3 engine parity — the plain version substituted for the kernel (in
     this script only): identical greedy streams at the smoke size with
     prompts far past the window, identical tokens at full width (4
     layers, fp32) with a prompt over 4x the window.

One JSON line per phase; then the card line from nvidia-smi, the kernels
line and, last, ``{"ok": true, "device": {...}}``. Any failed phase raises,
so the run exits non-zero and prints no result. Without a CUDA device it
exits 2 before doing anything.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import re
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
BF16_FLOP_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
ATOL, RTOL, TIE = 2e-5, 1e-5, 1e-4
MAIN = dict(B=4, Hkv=8, G=2, D=128, b=128, nb=32, m=16)  # qwen3-1.7b serving
SMOKE = dict(B=4, Hkv=2, G=2, D=16, b=16, nb=4, m=2)     # its smoke config
WIDTHS = ((1, "latency"), (128, "throughput"), (5, "throughput"))
# the long-context slice (levels=3): 2 slots of 4096-token windows; NU
# collapsed entries per (batch, kv-head) row: 32 per level + the tail
UP_MAIN = dict(B=2, Hkv=8, G=2, D=128, b=128, nb=32, m=16)
UP_CASES = (("main", UP_MAIN, 33), ("main", UP_MAIN, 65),
            ("smoke", SMOKE, 5), ("smoke", SMOKE, 40))
UP_WIDTHS = ((1, "latency"), (512, "throughput"), (5, "throughput"))
UP_PATTERNS = ("all_live", "some_dead", "all_dead", "tail_only")
L2_COPIES = 4  # cache copies cycled by the H-level timing (> 50 MB L2)
LONG = dict(slots=2, max_len=4096, chunk=512, prompts=(65536, 6000),
            new_tokens=(8, 64))
# block-sparse attention of qwen3-1.7b train_4k (batch cut to 2) and of its
# smoke config; Hq query heads, G per KV head
BSA_MAIN = dict(B=2, Hq=16, n=4096, d=128, b=128, bpr=4)
BSA_SMOKE = dict(B=2, Hq=4, n=256, d=16, b=16, bpr=2)
# phase 6's further cases (G = 2, bf16 and fp32): a hot key tile at the main
# shapes, and the smoke shapes at a head dim the kernels zero-pad (12 -> 16)
BSA_EXTRA = (("main-hot", BSA_MAIN, True), ("smoke-d12", dict(BSA_SMOKE, d=12),
                                            False))
# fp32 sums in another order and FMA contraction: normalized numerator and
# max-scaled gradients at rtol/atol 1e-4, the stabilizer mt at abs 1e-5
BSA_TOL, MT_TOL = 1e-4, 1e-5
TRAIN = dict(seq=4096, batch=2, steps=3)  # train_4k with the batch cut to 2


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
    score), the (B, Hkv, G, C, nb) selection grid, and the (row, key) pairs
    the exact term attends — all from the plain version's fp32 scores."""
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
    b = pre.block_size
    j = torch.arange(b, device=top.device)
    pos = pre.pb[:, None, None, None, :, None] * b + j  # (B,1,1,1,nb,b)
    ok = (pos >= 0) & (pos <= q_pos[:, None, None, :, None, None])
    pairs = int((grid[..., None] & ok).sum())
    return margin, grid, pairs


def tile_union_pages(torch, grid, c_tile):
    """Mean over (B·Hkv, query tile) of the pages in the tile's union."""
    B, Hkv, G, C, nb = grid.shape
    tiles = -(-C // c_tile)
    pad = torch.zeros((B, Hkv, G, tiles * c_tile - C, nb), dtype=torch.bool,
                      device=grid.device)
    g = torch.cat([grid, pad], 3).reshape(B, Hkv, G, tiles, c_tile, nb)
    return float(g.any(4).any(2).sum(-1).float().mean())


def bound(pre, k, q_pos, ks, grid, pairs, nu=0):
    """Least time for this call: bytes it must move (each input read once,
    the output written once) over HBM bandwidth vs its operations over the
    bf16 tensor-core rate and over the fp32 CUDA-core rate; ``nu``
    collapsed entries (the H-level program) add their fp32 means and counts
    and 2·rows·NU·D·2 operations (scores + fold). Returns a dict with
    ``bound_ms`` / ``bound_by`` at the bf16 rate, ``bound_ms_fp32_rate`` /
    ``bound_by_fp32_rate``, ``bytes`` and ``flops``."""
    B, Hkv, G, C, D = pre.qg.shape
    b, nb = pre.block_size, pre.pb.shape[1]
    page = b * D * k.element_size() + (b * 4 if ks is not None else 0)
    rows = B * Hkv * G * C
    union = grid.any(3).any(2)  # (B, Hkv, nb): pages read at least once
    nbytes = (2 * int(union.sum()) * page          # selected K/V pages (+scales)
              + 2 * B * Hkv * nb * D * 4           # page means k_ds, v_ds
              + 2 * B * nb * 4                     # counts, page table
              + rows * D * 4 + B * C * 4           # queries, positions
              + rows * D * 4                       # output
              + 2 * B * Hkv * nu * D * 4 + B * nu * 4)  # hk, hv, hcnt
    flops = (2 * 2 * rows * nb * D                 # coarse scores + background
             + 2 * 2 * pairs * D                   # exact scores + P.V
             + 2 * 2 * rows * nu * D)              # upper scores + fold
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = {"bytes": nbytes, "flops": flops}
    for key, rate in (("", BF16_FLOP_PER_S), ("_fp32_rate", FP32_FLOP_PER_S)):
        t_ops = flops / rate
        out[f"bound_ms{key}"] = 1e3 * max(t_bytes, t_ops)
        out[f"bound_by{key}"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


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
    bsa_ptx = ptxas_report(
        libs["block_sparse_attn"].with_suffix(".log").read_text())
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas_chunk_attn": ptxas_report(
              libs["chunk_attn"].with_suffix(".log").read_text()),
          "ptxas_block_sparse_attn": bsa_ptx})
    # 18 = bf16 and fp32 x three (D, b) x bsa_fwd, bsa_bwd_dq, bsa_bwd_dkv
    spills = [k for k in bsa_ptx if k["kernel"].startswith(
        ("bsa_fwd bf16", "bsa_bwd_dq bf16", "bsa_bwd_dkv bf16"))
        and (k["spill_stores"] or k["spill_loads"] or k["registers"] > 255)]
    if len(bsa_ptx) != 18 or spills:
        raise AssertionError(f"bsa kernels: {len(bsa_ptx)} built, spilling "
                             f"bf16 tensor-core kernels {spills}")
    return smi


def _kernel_label(name):
    """A readable label of a mangled kernel name: chunk_attn by storage
    type, D and program; bsa_* by kernel, input type, D and b."""
    if "combine" in name:
        return "combine"
    dims = re.findall(r"Li(\d+)E", name)
    if "bsa_" in name:
        kind = re.search(r"(bsa_\w+?)_kernel", name).group(1)
        dt = "bf16" if "bfloat16" in name else "fp32"
        return " ".join([kind, dt] + [f"{k}={v}" for k, v in zip("Db", dims)])
    dt = ("bf16" if "bfloat16" in name else
          "int8" if "chunk_attn_kernelIa" in name else "fp32")
    up = "upper" if name.count("Lb1E") else "two_level"
    return f"{dt} D={dims[0] if dims else '?'} {up}"


def ptxas_report(log):
    """Registers and spill bytes per kernel from nvcc's -Xptxas=-v output,
    named by ``_kernel_label``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"kernel": _kernel_label(name),
                        "registers": int(m.group(1)),
                        "spill_stores": spills[0], "spill_loads": spills[1]})
            name = None
    return out


def _hold(torch, tmd, got, pre, q_pos, m, ref, label):
    """(max |err| outside near ties, near-tie rows, rows) of kernel vs plain;
    raises on a disagreement outside the near ties or a non-finite value."""
    margin, _, _ = selection_stats(torch, tmd, pre, q_pos, m)
    tie = (margin < TIE).reshape(got.shape[:3])[..., None]
    close = torch.isclose(got, ref, atol=ATOL, rtol=RTOL) | tie
    err = float(torch.where(tie, 0.0, (got - ref).abs()).max())
    if not bool(close.all()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"chunk_attn kernel != plain version: {label}: "
                             f"max |err| {err}")
    return err, int(tie.sum()), tie.numel()


def _planned(torch, chunk_attn, pre, mode="auto"):
    """The split count the wrapper plans for ``pre`` on this card."""
    return chunk_attn.launch_geometry(pre, torch.bfloat16, mode=mode,
                                      sms=chunk_attn.sm_count(0))["nsplit"]


def phase_kernel_vs_plain(torch, tmd, chunk_attn):
    worst, ties, rows, n = 0.0, 0, 0, 0
    cases = [((name, sh), (C, mode), None) for (name, sh), (C, mode)
             in itertools.product((("main", MAIN), ("smoke", SMOKE)), WIDTHS)]
    # decode split across blocks, the count forced: serving and long context
    cases += [((name, sh), (1, "latency"), ns) for (name, sh), ns
              in itertools.product((("main", MAIN), ("long", UP_MAIN)),
                                   (1, 2, "plan"))]
    forced = 0
    for (name, sh), (C, mode), nsplit in cases:
        for layout, dtype, variant in itertools.product(
                ("dense", "ring", "ragged"), ("bf16", "int8"),
                ("full", "sparse")):
            n += 1
            pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + n, sh, C,
                                                   layout, dtype)
            kw = dict(m=sh["m"], k_scale=ks, v_scale=vs,
                      include_bg=variant == "full", mode=mode)
            if nsplit is None:
                got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
            else:
                ns = (_planned(torch, chunk_attn, pre) if nsplit == "plan"
                      else nsplit)
                got = chunk_attn._launch(pre, k, v, q_pos, nsplit=ns, **kw)
                forced += 1
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            torch.cuda.synchronize()
            err, t, r = _hold(torch, tmd, got, pre, q_pos, sh["m"], ref,
                              f"{name} C={C} {mode} nsplit={nsplit} {layout} "
                              f"{dtype} {variant}")
            worst, ties, rows = max(worst, err), ties + t, rows + r
    emit({"phase": "kernel_vs_plain", "kernel": "chunk_attn", "cases": n,
          "forced_split_cases": forced, "forced_nsplit": [1, 2, "plan"],
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
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, MAIN["m"])
        out[label] = {"C": C, "mode": mode, "ms": ms, "plain_ms": plain_ms,
                      **bound(pre, k, q_pos, ks, grid, pairs),
                      **launch_info(torch, chunk_attn, pre, k, grid, mode,
                                    upper=False)}
    emit({"phase": "kernel_timing", "kernel": "chunk_attn", "shape": MAIN,
          "cache": "bf16", "layout": "dense 4096-token slots", **out})
    return out


def launch_info(torch, chunk_attn, pre, k, grid, mode, upper):
    """The launch's split, grid, shared memory, blocks per SM (occupancy
    API) and the mean pages in a query tile's selection union."""
    geo = chunk_attn.launch_geometry(pre, k.dtype, mode=mode,
                                     sms=chunk_attn.sm_count(0))
    B, Hkv, G, C, D = pre.qg.shape
    return {"nsplit": geo["nsplit"], "grid": geo["grid"],
            "smem_bytes": geo["smem"],
            "blocks_per_sm": chunk_attn.blocks_per_sm(
                k.dtype, D, pre.block_size, upper, geo["smem"]),
            "sms": chunk_attn.sm_count(0),
            "union_pages_per_tile": tile_union_pages(torch, grid,
                                                     geo["c_tile"])}


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
        _reset_chunk(chunk_attn)
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, upper = _chunk_launches(chunk_attn)
        combines = chunk_attn.chunk_attention_kernel.combine_launches
    st = eng.stats
    want_comb = _want_combines(chunk_attn, cfg, st, 4, 128, 4096)
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
          "kernel_launches": launches, "combine_launches": combines,
          "evicted_tokens": float(eng.kv.occupancy()["tokens_evicted"])})
    if launches != cfg.num_layers * dispatches or upper != 0:
        raise AssertionError(f"{launches} kernel launches (+{upper} of the "
                             f"H-level program) != {cfg.num_layers} x "
                             f"{dispatches} dispatches")
    if combines != want_comb:
        raise AssertionError(f"{combines} combine launches != {want_comb}")
    if int(bad) != 0:
        raise AssertionError(f"{int(bad)} non-finite logits")
    if any(len(o) != 192 or int(o.min()) < 0 or int(o.max()) >= cfg.vocab
           for o in outs):
        raise AssertionError("a stream is short or holds an out-of-vocab token")
    return (launches, combines), eng


def _reset_chunk(chunk_attn):
    fn = chunk_attn.chunk_attention_kernel
    fn.launches = fn.upper_launches = fn.combine_launches = 0


def _want_combines(chunk_attn, cfg, stats, slots, chunk, max_len):
    """Combine launches an engine run must make: one per layer of every
    dispatch whose planned split count is above 1 (decode: C = 1; prefill:
    C = chunk, the scheduler's fixed width)."""
    G = cfg.num_heads // cfg.kv_heads
    nb = max_len // cfg.attention.block_size
    want = 0
    for C, key in ((1, "decode_dispatches"), (chunk, "prefill_dispatches")):
        tiles = -(-C // chunk_attn.tile_width("auto", C, G))
        if chunk_attn.split_plan(slots, cfg.kv_heads, tiles, nb,
                                 chunk_attn.sm_count(0))[0] > 1:
            want += cfg.num_layers * stats[key]
    return want


def _chunk_launches(chunk_attn):
    """(two-level launches, H-level launches) of the chunk kernel."""
    fn = chunk_attn.chunk_attention_kernel
    return fn.launches, fn.upper_launches


def _profile(torch, fn, steps, kernels=("chunk_attn",)):
    """Wall ms per call without the profiler, then torch.profiler over the
    same calls: device ms per call, busy share, the named kernels' ms and
    the top kernels."""
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
            **{f"{name}_ms": sum(ms for k, ms in rows if name in k)
               for name in kernels},
            "top": [[k[:100], ms] for k, ms in rows[:10]]}


def phase_profile(torch, eng, C=128, phase="profile"):
    """Where a full-width dispatch's time goes, on the engine's own cache
    after its run: decode waves of every slot, and C-token prefill chunks."""
    from repro_torch.models import transformer
    from repro_torch.serve.sampling import greedy_batch

    B = eng.slots
    toks = torch.arange(1, B + 1, device=DEVICE)
    active = torch.ones(B, dtype=torch.bool, device=DEVICE)
    chunk = (torch.arange(1, B * C + 1, device=DEVICE)
             % eng.cfg.vocab).reshape(B, C)
    nv = torch.full((B,), C, dtype=torch.int32, device=DEVICE)

    def decode():
        logits, _ = transformer.decode_step(eng.params, eng.cfg, eng.kv.tree,
                                            toks, active=active)
        greedy_batch(logits, vocab=eng.cfg.vocab).cpu()

    def prefill():
        transformer.prefill_chunk(eng.params, eng.cfg, eng.kv.tree, chunk, nv)

    emit({"phase": phase, "note": "ms per dispatch; device_ms = summed "
          "kernel time from torch.profiler; busy_share = device_ms / wall_ms",
          "slots": B, "decode_step": _profile(torch, decode, 10),
          f"prefill_chunk_{C}": _profile(torch, prefill, 3)})


def _streams(torch, chunk_attn, cfg, params, ecfg, reqs, plain):
    """{prompt length: greedy tokens}; ``plain`` substitutes the plain
    version for the kernel (here only). The kernel run must launch only the
    program of the config's depth (H-level at ``levels >= 3``)."""
    from repro_torch.serve import Engine

    def ref(pre, k_cache, v_cache, q_pos, **kw):
        return chunk_attn.chunk_attention_ref(pre, k_cache, v_cache, q_pos, **kw)

    _reset_chunk(chunk_attn)
    if plain:
        with mock.patch.object(chunk_attn, "chunk_attention_kernel", ref):
            done = Engine(cfg, params, ecfg, device=DEVICE).run(reqs)
    else:
        done = Engine(cfg, params, ecfg, device=DEVICE).run(reqs)
    two, upper = _chunk_launches(chunk_attn)
    hier = cfg.attention.levels >= 3
    if (two + upper == 0) != plain or (upper if not hier else two) != 0:
        raise AssertionError(f"plain={plain} levels={cfg.attention.levels} "
                             f"run made {two} + {upper} (H-level) launches")
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


# --------------------------------------------------------------------------- #
# training path: block-sparse attention kernels and the train loop
# --------------------------------------------------------------------------- #
BSA_KERNELS = ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv")


def _reset_bsa(bsa):
    for name in BSA_KERNELS:
        getattr(bsa, name).launches = 0


def _bsa_launches(bsa):
    return {name: getattr(bsa, name).launches for name in BSA_KERNELS}


def bsa_case(torch, sh, G, dtype, seed, edited, hot=False):
    """(q, k, v, c, x, y, flags, km, scale) for one comparison, numpy from
    ``seed``; pairs from a real causal MRA-2 selection (``select_blocks``).
    ``edited`` pads the keys of batch row 1, invalidates every 7th pair and
    leaves query block 1 of BHG row 0 without pairs. ``hot`` makes the first
    nb pairs of every row (x, 0) for x = 0 .. nb - 1, so key tile 0 of each
    KV head walks G·nb pairs more than the rest."""
    from repro_torch.core.mra import MraConfig, kernel_pairs, select_blocks

    r = np.random.default_rng(seed)
    B, Hq, n, d, b = (sh[k] for k in ("B", "Hq", "n", "d", "b"))
    Hkv = Hq // G
    q = r.standard_normal((B, Hkv, G, n, d), np.float32)
    k = r.standard_normal((B, Hkv, n, d), np.float32)
    v = r.standard_normal((B, Hkv, n, d), np.float32)
    lengths = np.array([n, n - (3 * b) // 2 if edited else n])
    key_mask = torch.as_tensor(np.arange(n)[None] < lengths[:, None],
                               device=DEVICE)
    q, k, v = (torch.from_numpy(a).to(DEVICE, dtype) for a in (q, k, v))
    cfg = MraConfig(block_size=b, blocks_per_row=sh["bpr"], causal=True)
    scale = d ** -0.5
    sel = select_blocks(q, k, v, key_mask, cfg, scale)
    c, x, y, flags = kernel_pairs(sel, causal=True)
    if edited:
        flags[:, ::7] &= ~1
        x[0] = torch.where(x[0] == 1, 0, x[0])
    if hot:
        nb = n // b
        x[:, :nb] = torch.arange(nb, device=x.device, dtype=x.dtype)
        y[:, :nb] = 0
        flags[:, :nb] = 1 | 2 * (x[:, :nb] == 0).to(flags.dtype)
    km = key_mask[:, None].expand(B, Hkv, n).reshape(B * Hkv, n)
    return (q.reshape(B * Hkv * G, n, d), k.reshape(B * Hkv, n, d),
            v.reshape(B * Hkv, n, d), c, x.contiguous(), y, flags.contiguous(),
            km.to(torch.int32).contiguous(), scale)


def _scaled_close(torch, got, want, tol):
    """(max |err|, ok) of got vs want, both divided by max |want|."""
    s = float(want.abs().max()) or 1.0
    ok = torch.isclose(got / s, want / s, rtol=tol, atol=tol).all()
    return float((got - want).abs().max()), bool(ok)


def phase_bsa_vs_plain(torch, bsa):
    worst = dict.fromkeys(BSA_KERNELS, 0.0)
    worst_mt, n, unvisited = 0.0, 0, 0
    dtypes = (torch.bfloat16, torch.float32)
    cases = [(name, sh, dtype, G, edited, False)
             for (name, sh), dtype, G, edited in itertools.product(
                 (("main", BSA_MAIN), ("smoke", BSA_SMOKE)), dtypes, (1, 2),
                 (False, True))]
    cases += [(name, sh, dtype, 2, False, hot)
              for (name, sh, hot), dtype in itertools.product(BSA_EXTRA, dtypes)]
    for name, sh, dtype, G, edited, hot in cases:
        n += 1
        q, k, v, c, x, y, fl, km, scale = bsa_case(torch, sh, G, dtype,
                                                   SEED + n, edited, hot)
        b, nb = sh["b"], sh["n"] // sh["b"]
        pq = bsa.group_by_query(x, y, fl, nb)
        pk = bsa.group_by_key(x, y, fl, G, nb)
        kw = dict(scale=scale, block_size=b)
        runs = [bsa.bsa_fwd(q, k, v, c, pq, km, **kw) for _ in range(2)]
        ref = bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw)
        r = np.random.default_rng(SEED + 100 + n)
        do = torch.from_numpy(r.standard_normal(tuple(q.shape), np.float32)).to(DEVICE)
        dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2]), np.float32)).to(DEVICE)
        mt = runs[0][2]
        grads = [(bsa.bsa_bwd_dq(q, k, v, mt, do, dr, pq, km, **kw),
                  *bsa.bsa_bwd_dkv(q, k, v, mt, do, dr, pk, km, **kw))
                 for _ in range(2)]
        gref = bsa.block_sparse_attention_bwd_ref(q, k, v, c, x, y, fl, km,
                                                  do, dr, **kw)
        torch.cuda.synchronize()
        label = f"{name} {dtype} G={G} edited={edited}"
        for a, bb in zip(runs[0] + grads[0], runs[1] + grads[1]):
            if not torch.equal(a, bb):
                raise AssertionError(f"bsa kernels not bit-identical: {label}")
        out, rs, mt = runs[0]
        alive_k, alive_p = rs > 0, ref[1] > 0
        if not torch.equal(alive_k, alive_p):
            raise AssertionError(f"bsa_fwd live rows differ: {label}")
        dead = ~alive_k
        if bool(out[dead].any()) or bool(rs[dead].any()):
            raise AssertionError(f"bsa_fwd dead rows not zero: {label}")
        unvisited += int(dead.sum())
        norm_k = torch.where(alive_k[..., None], out, 0.0) / torch.where(
            alive_k, rs, 1.0)[..., None]
        norm_p = torch.where(alive_p[..., None], ref[0], 0.0) / torch.where(
            alive_p, ref[1], 1.0)[..., None]
        err = float((norm_k - norm_p).abs().max())
        mt_err = float((mt - ref[2]).abs().max())
        ok = (bool(torch.isclose(norm_k, norm_p, rtol=BSA_TOL, atol=BSA_TOL).all())
              and bool(torch.isclose(rs, ref[1], rtol=BSA_TOL, atol=BSA_TOL).all())
              and mt_err <= MT_TOL)
        if not ok or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bsa_fwd != plain: {label}: normalized "
                                 f"{err}, mt {mt_err}")
        worst["bsa_fwd"] = max(worst["bsa_fwd"], err)
        worst_mt = max(worst_mt, mt_err)
        for kname, got, want in (("bsa_bwd_dq", grads[0][0], gref[0]),
                                 ("bsa_bwd_dkv", grads[0][1], gref[1]),
                                 ("bsa_bwd_dkv", grads[0][2], gref[2])):
            gerr, gok = _scaled_close(torch, got, want, BSA_TOL)
            if not gok:
                raise AssertionError(f"{kname} != plain: {label}: {gerr}")
            worst[kname] = max(worst[kname], gerr)
    emit({"phase": "bsa_vs_plain", "cases": n, "rtol": BSA_TOL,
          "atol": BSA_TOL, "mt_atol": MT_TOL, "max_abs_err": worst,
          "max_mt_err": worst_mt, "unvisited_rows": unvisited,
          "bit_identical_reruns": True})
    return worst


def _bsa_bounds(q, k, flags, nb, outputs, products):
    """Least time for one block-sparse call: bytes (q, k, v, the pair lists
    and their per-token inputs read once, outputs written once) over HBM vs
    2·products·d operations per score entry the pairs need (b² for a valid
    pair, b(b+1)/2 for a diagonal one: flags bit0 and bit1) over the bf16
    tensor-core rate and the fp32 CUDA-core rate."""
    BHG, n, d = q.shape
    BHKV = k.shape[0]
    b = n // nb
    valid = (flags & 1) == 1
    diag = int((valid & ((flags & 2) == 2)).sum())
    full = int(valid.sum()) - diag
    entries = full * b * b + diag * b * (b + 1) // 2
    nbytes = (q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
              + BHKV * n * 4 + outputs)
    flops = 2 * products * entries * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = {"bytes": nbytes, "flops": flops, "full_pairs": full,
           "diagonal_pairs": diag}
    for label, rate in (("bf16", BF16_FLOP_PER_S), ("fp32", FP32_FLOP_PER_S)):
        t_ops = flops / rate
        out[f"bound_ms_{label}"] = 1e3 * max(t_bytes, t_ops)
        out[f"bound_by_{label}"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def phase_bsa_timing(torch, bsa):
    import torch.nn.functional as F

    sh = BSA_MAIN
    q, k, v, c, x, y, fl, km, scale = bsa_case(torch, sh, 2, torch.bfloat16,
                                               SEED, False)
    BHG, n, d = q.shape
    BHKV = k.shape[0]
    b, nb = sh["b"], n // sh["b"]
    m = x.shape[1]
    pairs = int((fl & 1).sum())
    pq = bsa.group_by_query(x, y, fl, nb)
    pk = bsa.group_by_key(x, y, fl, 2, nb)
    kw = dict(scale=scale, block_size=b)
    out, rs, mt = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)
    r = np.random.default_rng(SEED)
    do = torch.from_numpy(r.standard_normal(tuple(q.shape), np.float32)).to(DEVICE)
    dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2]), np.float32)).to(DEVICE)
    lists = 3 * BHG * m * 4 + BHG * (nb + 1) * 4
    res = {"fwd": {"ms": time_ms(torch, lambda: bsa.bsa_fwd(
               q, k, v, c, pq, km, **kw), 20),
               "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_ref(
                   q, k, v, x, y, fl, c, km, **kw), 5),
               **_bsa_bounds(q, k, fl, nb, BHG * nb * 4 + lists
                             + BHG * n * (d + 2) * 4, 2)}}
    bwd_in = lists + BHG * n * (d + 2) * 4  # pair lists, do, dr, mt
    plain_args = (q, k, v, c, x, y, fl, km, do, dr)
    res["dq"] = {"ms": time_ms(torch, lambda: bsa.bsa_bwd_dq(
        q, k, v, mt, do, dr, pq, km, **kw), 10),
        "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_bwd_dq_ref(
            *plain_args, **kw), 5),
        **_bsa_bounds(q, k, fl, nb, bwd_in + BHG * n * d * 4, 3)}
    res["dkv"] = {"ms": time_ms(torch, lambda: bsa.bsa_bwd_dkv(
        q, k, v, mt, do, dr, pk, km, **kw), 10),
        "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_bwd_dkv_ref(
            *plain_args, **kw), 5),
        **_bsa_bounds(q, k, fl, nb, bwd_in + 2 * BHKV * n * d * 4, 4)}
    # the tensor-core kernels' launch: grid, block, occupancy, pair balance
    for key, pairs_, tiles in (("fwd", pq, BHG * nb), ("dq", pq, BHG * nb),
                               ("dkv", pk, BHKV * nb)):
        counts = bsa.pairs_per_tile(pairs_.ptr).float()
        res[key].update(
            bsa.launch_geometry(key, q.dtype, d, b, tiles),
            blocks_per_sm=bsa.blocks_per_sm(key, q.dtype, d, b),
            pairs_per_tile={"min": float(counts.min()),
                            "mean": float(counts.mean()),
                            "max": float(counts.max())})

    def both():
        bsa.bsa_bwd_dq(q, k, v, mt, do, dr, pq, km, **kw)
        bsa.bsa_bwd_dkv(q, k, v, mt, do, dr, pk, km, **kw)

    plain_bwd = time_ms(torch, lambda: bsa.block_sparse_attention_bwd_ref(
        *plain_args, **kw), 5)
    res["bwd_pair"] = {"ms": time_ms(torch, both, 10), "plain_ms": plain_bwd,
                       **_bsa_bounds(q, k, fl, nb, bwd_in + (
                           BHG + 2 * BHKV) * n * d * 4, 5)}
    # exact causal attention on the same q/k/v (KV heads repeated): a
    # yardstick, not the same function; the port never calls it
    B = sh["B"]
    qs = q.reshape(B, -1, n, d).detach().requires_grad_(True)
    ks, vs = (t.reshape(B, -1, n, d).repeat_interleave(2, dim=1)
              .detach().requires_grad_(True) for t in (k, v))
    go = torch.randn_like(qs)

    def sdpa():
        F.scaled_dot_product_attention(qs, ks, vs, is_causal=True).backward(go)

    dense = time_ms(torch, sdpa, 10)
    emit({"phase": "bsa_timing", "shape": BSA_MAIN, "dtype": "bfloat16",
          "G": 2, "pairs": pairs, "pairs_per_row": m, "dense_sdpa_ms": dense,
          "note": "plain_ms: dq and dkv time the plain backward's dq part "
                  "and (dk, dv) part alone, bwd_pair the whole plain "
                  "backward", **res})
    return res, dense


def phase_train_full_width(torch, bsa):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.train import TrainConfig, train

    cfg = get_config("qwen3-1.7b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    tc = TrainConfig(steps=TRAIN["steps"], seed=SEED)
    steps = []

    def on_metrics(step, m):
        steps.append({"step": step, "loss": m["loss"],
                      "grad_norm": m["grad_norm"], "lr": m["lr"],
                      "seconds": m["step_time_s"],
                      "tokens_per_s": shape.seq_len * shape.global_batch
                      / m["step_time_s"]})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_bsa(bsa)
    t0 = time.perf_counter()
    params, opt_state, _ = train(cfg, shape, tc, device=DEVICE,
                                 on_metrics=on_metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bsa_launches(bsa)
    emit({"phase": "train_full_width", "arch": cfg.name,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "param_dtype": cfg.param_dtype, "activ_dtype": cfg.activ_dtype,
          "remat": cfg.remat, "attention": dataclasses.asdict(cfg.attention),
          "seq_len": shape.seq_len, "batch": shape.global_batch,
          "steps": steps, "wall_s": wall,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "kernel_launches": launches})
    want = {"bsa_fwd": cfg.num_layers * tc.steps * 2,  # forward + remat
            "bsa_bwd_dq": cfg.num_layers * tc.steps,
            "bsa_bwd_dkv": cfg.num_layers * tc.steps}
    if launches != want:
        raise AssertionError(f"bsa launches {launches} != {want}")
    if not all(np.isfinite([s["loss"], s["grad_norm"]]).all() for s in steps):
        raise AssertionError(f"non-finite loss or grad norm: {steps}")
    return launches, (cfg, tc, shape, params, opt_state)


def phase_train_profile(torch, state):
    """Where one full-width training step's time goes (kernel rows only)."""
    from repro_torch.data import make_batch
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step

    cfg, tc, shape, params, opt_state = state
    step_fn = make_train_step(cfg, tc, AdamW(), cosine_schedule(
        tc.lr, tc.warmup, tc.steps))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             make_batch(cfg, shape, step=tc.steps, seed=tc.seed).items()}

    def step():
        nonlocal params, opt_state
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        float(metrics["loss"])

    emit({"phase": "train_profile", "note": "ms per training step; "
          "device_ms = summed kernel time from torch.profiler",
          "train_step": _profile(torch, step, 1, kernels=BSA_KERNELS)})


def _train_run(torch, bsa, cfg, shape, steps, plain):
    """[(loss, grad_norm)] of ``train()``; ``plain`` substitutes the plain
    versions for the kernels (here only)."""
    from repro_torch.train import TrainConfig, train

    def fwd(q, k, v, c, x, y, fl, km, scale, block_size):
        return (*bsa.block_sparse_attention_ref(
            q, k, v, x, y, fl, c, km, scale=scale, block_size=block_size), None)

    def bwd(q, k, v, c, mt, pairs, x, y, fl, km, do, dr, scale, block_size):
        return bsa.block_sparse_attention_bwd_ref(
            q, k, v, c, x, y, fl, km, do, dr, scale=scale, block_size=block_size)

    out = []
    _reset_bsa(bsa)
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(mock.patch.object(bsa, "_forward", fwd))
            stack.enter_context(mock.patch.object(bsa, "_backward", bwd))
        train(cfg, shape, TrainConfig(steps=steps, seed=SEED, log_every=10**9),
              device=DEVICE,
              on_metrics=lambda s, m: out.append((m["loss"], m["grad_norm"])))
    launches = sum(_bsa_launches(bsa).values())
    if (launches == 0) != plain:
        raise AssertionError(f"plain={plain} training made {launches} launches")
    return np.array(out)


def phase_train_parity(torch, bsa):
    from repro_torch.configs import SHAPES, get_config, get_smoke_config

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    small = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=256, global_batch=2)
    k, p = (_train_run(torch, bsa, small, shape, 3, plain) for plain in (False, True))
    result = {"smoke": {"steps": 3, "loss_kernel": k[:, 0].tolist(),
                        "loss_plain": p[:, 0].tolist(),
                        "loss_rel": rel(k[:, 0], p[:, 0]),
                        "grad_norm_rel": rel(k[:, 1], p[:, 1])}}
    if result["smoke"]["loss_rel"] > 1e-5:
        raise AssertionError(f"smoke training losses differ: {result}")
    full4 = get_config("qwen3-1.7b", num_layers=4, activ_dtype="float32")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    k, p = (_train_run(torch, bsa, full4, shape, 1, plain) for plain in (False, True))
    result["full_width_4_layers"] = {
        "loss_kernel": float(k[0, 0]), "loss_plain": float(p[0, 0]),
        "grad_norm_kernel": float(k[0, 1]), "grad_norm_plain": float(p[0, 1]),
        "loss_rel": rel(k[:, 0], p[:, 0]), "grad_norm_rel": rel(k[:, 1], p[:, 1])}
    emit({"phase": "train_parity", "dtype": "float32", **result})
    f = result["full_width_4_layers"]
    if f["loss_rel"] > 1e-4 or f["grad_norm_rel"] > 1e-4:
        raise AssertionError(f"full-width training differs: {f}")


# --------------------------------------------------------------------------- #
# long-context serving: the H-level program of the chunk kernel (levels >= 3)
# --------------------------------------------------------------------------- #
def upper_view(torch, seed, B, Hkv, D, nu, pattern):
    """A random H-level view (core.hier.HierUpper) of ``nu`` entries made on
    the card from ``seed``; pattern: all_live | some_dead | all_dead |
    tail_only. Entries 1-2 carry 3x keys so that their scores can lead the
    row stabilizer."""
    from repro_torch.core.hier import HierUpper

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    km = torch.randn((B, Hkv, nu, D), generator=g, device=DEVICE)
    km[:, :, 1:3] *= 3.0
    vm = torch.randn((B, Hkv, nu, D), generator=g, device=DEVICE)
    cnt = torch.randint(1, 257, (B, nu), generator=g, device=DEVICE).float()
    if pattern == "some_dead":
        cnt[:, ::2] = 0.0
    elif pattern == "all_dead":
        cnt.zero_()
    elif pattern == "tail_only":
        cnt[:, :-1] = 0.0
    return HierUpper(km, vm, cnt)


def phase_upper_vs_plain(torch, tmd, chunk_attn):
    fn = chunk_attn.chunk_attention_kernel
    worst, ties, rows, n, calls = 0.0, 0, 0, 0, 0
    empty_rows = 0
    upper0 = fn.upper_launches
    for (name, sh, nu), (C, mode), layout, dtype in itertools.product(
            UP_CASES, UP_WIDTHS, ("ring", "ragged"), ("bf16", "int8")):
        n += 1
        pre2, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + 500 + n, sh,
                                                C, layout, dtype)
        margin, _, _ = selection_stats(torch, tmd, pre2, q_pos, sh["m"])
        tie = (margin < TIE).reshape(pre2.qg.shape[0], -1, C)[..., None]
        label = f"{name} NU={nu} C={C} {mode} {layout} {dtype}"
        kw = dict(m=sh["m"], k_scale=ks, v_scale=vs, mode=mode)
        for i, pattern in enumerate(UP_PATTERNS):
            up = upper_view(torch, SEED + 1000 * n + i, sh["B"], sh["Hkv"],
                            sh["D"], nu, pattern)
            pre = pre2._replace(upper=up)
            got = fn(pre, k, v, q_pos, include_bg=True, **kw)
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos,
                                                 include_bg=True, **kw)
            calls += 1
            torch.cuda.synchronize()
            close = torch.isclose(got, ref, atol=ATOL, rtol=RTOL) | tie
            err = float(torch.where(tie, 0.0, (got - ref).abs()).max())
            if not bool(close.all()) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"chunk_attn H-level program != plain: "
                                     f"{label} {pattern}: max |err| {err}")
            if layout == "ragged" and pattern != "all_dead":
                # slot 0 holds no live window key; its live entries answer
                if not bool((got[0].abs().amax(-1) > 0).all()):
                    raise AssertionError(f"empty-window rows are zero: {label}")
                empty_rows += got[0].shape[0] * got[0].shape[1]
            worst = max(worst, err)
            ties += int(tie.sum())
            rows += tie.numel()
        # MRA-2-s ignores the hierarchy: the two-level program, same output
        kw_s = dict(kw, include_bg=False)
        a = fn(pre, k, v, q_pos, **kw_s)
        b = fn(pre2, k, v, q_pos, **kw_s)
        ref = chunk_attn.chunk_attention_ref(pre2, k, v, q_pos, **kw_s)
        torch.cuda.synchronize()
        close = torch.isclose(a, ref, atol=ATOL, rtol=RTOL) | tie
        if not torch.equal(a, b) or not bool(close.all()):
            raise AssertionError(f"MRA-2-s output changed by the view: {label}")
    # decode split across blocks, the count forced, at the slice's shape
    forced = 0
    for nu, nsplit, layout, dtype in itertools.product(
            (33, 65), (1, 2, "plan"), ("ring", "ragged"), ("bf16", "int8")):
        n += 1
        pre2, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + 500 + n,
                                                UP_MAIN, 1, layout, dtype)
        for i, pattern in enumerate(UP_PATTERNS):
            pre = pre2._replace(upper=upper_view(
                torch, SEED + 1000 * n + i, UP_MAIN["B"], UP_MAIN["Hkv"],
                UP_MAIN["D"], nu, pattern))
            ns = (_planned(torch, chunk_attn, pre) if nsplit == "plan"
                  else nsplit)
            kw = dict(m=UP_MAIN["m"], k_scale=ks, v_scale=vs, mode="latency")
            got = chunk_attn._launch(pre, k, v, q_pos, nsplit=ns, **kw)
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            calls += 1
            forced += 1
            torch.cuda.synchronize()
            err, t, r = _hold(torch, tmd, got, pre, q_pos, UP_MAIN["m"], ref,
                              f"H-level NU={nu} nsplit={nsplit} {layout} "
                              f"{dtype} {pattern}")
            worst, ties, rows = max(worst, err), ties + t, rows + r
    if fn.upper_launches - upper0 != calls:
        raise AssertionError(f"{fn.upper_launches - upper0} H-level launches "
                             f"!= {calls} calls")
    emit({"phase": "upper_vs_plain", "kernel": "chunk_attn_upper",
          "cases": calls, "forced_split_cases": forced,
          "forced_nsplit": [1, 2, "plan"], "mra2_s_cases": n - forced // 4,
          "atol": ATOL,
          "rtol": RTOL, "max_abs_err": worst, "near_tie_rows": ties,
          "rows": rows, "tie_margin": TIE, "empty_window_rows": empty_rows,
          "nu": sorted({nu for _, _, nu in UP_CASES})})
    if ties > 0.01 * rows:
        raise AssertionError(f"{ties} near-tie rows of {rows} exceed 1%")
    return worst


def phase_upper_timing(torch, tmd, chunk_attn):
    """The H-level program (NU = 33) and the two-level one on the same
    4096-token bf16 windows of the long-context slice, beside the bound and
    the plain version. The two slots' K/V (33.5 MB) would stay in the 50 MB
    L2 across repeated calls, while the engine reads each layer's cache
    once per dispatch: every call here takes the next of ``L2_COPIES``
    copies of the cache (134 MB in all), so each finds its pages cold. The
    programs are timed in the order two-level, H-level, H-level, two-level
    and each keeps the mean of its two runs."""
    fn = chunk_attn.chunk_attention_kernel
    out = {}
    nu = 33
    for label, C, mode in (("decode", 1, "latency"),
                           ("chunk512", 512, "throughput")):
        pre2, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, UP_MAIN, C,
                                                "dense", "bf16")
        pre = pre2._replace(upper=upper_view(torch, SEED, UP_MAIN["B"],
                                             UP_MAIN["Hkv"], UP_MAIN["D"], nu,
                                             "all_live"))
        caches = [(k, v)] + [(k.clone(), v.clone())
                             for _ in range(L2_COPIES - 1)]
        turn = itertools.count()

        def cold(f, p):
            def call():
                kc, vc = caches[next(turn) % L2_COPIES]
                return f(p, kc, vc, q_pos, **kw)
            return call

        kw = dict(m=UP_MAIN["m"], include_bg=True, mode=mode)
        iters = 200 if C == 1 else 20
        runs = [time_ms(torch, cold(fn, p), iters)
                for p in (pre2, pre, pre, pre2)]
        ms, two_ms = (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2
        plain_ms = time_ms(torch, cold(chunk_attn.chunk_attention_ref, pre),
                           10)
        del caches
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, UP_MAIN["m"])
        two = bound(pre, k, q_pos, ks, grid, pairs)
        out[label] = {"C": C, "mode": mode, "ms": ms, "two_level_ms": two_ms,
                      "runs_ms": runs, "l2_copies": L2_COPIES,
                      "plain_ms": plain_ms,
                      **bound(pre, k, q_pos, ks, grid, pairs, nu=nu),
                      "two_level_bound_ms": two["bound_ms"],
                      "two_level_bound_ms_fp32_rate": two["bound_ms_fp32_rate"],
                      "union_pages": int(grid.any(3).any(2).sum()),
                      **launch_info(torch, chunk_attn, pre, k, grid, mode,
                                    upper=True)}
    emit({"phase": "upper_timing", "kernel": "chunk_attn_upper",
          "shape": UP_MAIN, "nu": nu, "cache": "bf16",
          "layout": "dense 4096-token slots, L2-cold", **out})
    return out


def phase_long_context(torch, chunk_attn):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_config("qwen3-1.7b")
    cfg = cfg.replace(attention=cfg.attention.replace(levels=3))
    params = init_params(cfg, seed=SEED, device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(
        slots=LONG["slots"], max_len=LONG["max_len"], chunk=LONG["chunk"]),
        device=DEVICE)
    r = np.random.default_rng(SEED)
    reqs = [Request(prompt=r.integers(0, cfg.vocab, n), max_new_tokens=t)
            for n, t in zip(LONG["prompts"], LONG["new_tokens"])]
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
    orig = (transformer.prefill_chunk, transformer.decode_step)

    def finite(f):  # counts non-finite logits on the device, no sync
        def wrapped(*a, **kw):
            logits, cache = f(*a, **kw)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(transformer, "prefill_chunk", finite(orig[0])), \
            mock.patch.object(transformer, "decode_step", finite(orig[1])):
        _reset_chunk(chunk_attn)
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        two, upper = _chunk_launches(chunk_attn)
        combines = chunk_attn.chunk_attention_kernel.combine_launches
    st = eng.stats
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    want_comb = _want_combines(chunk_attn, cfg, st, LONG["slots"], eng.chunk,
                               LONG["max_len"])
    kv, tree = eng.kv, eng.kv.tree
    lengths = kv.lengths.astype(np.int64)
    live = lengths - kv.window_start()
    level = {lv: tree[f"hier_cnt{lv}"].sum(-1).cpu().numpy().astype(np.int64)
             for lv in kv.hier_lids}
    tail = tree["tail_cnt"].cpu().numpy().astype(np.int64)
    held = live + sum(level.values()) + tail
    occ = kv.occupancy()
    emit({"phase": "long_context", "arch": cfg.name, "levels": 3,
          "layers": cfg.num_layers, "activ_dtype": cfg.activ_dtype,
          "param_dtype": cfg.param_dtype, **LONG, "chunk_used": eng.chunk,
          "wall_s": wall, "prefill_tokens": st["prefill_tokens"],
          "prefill_dispatches": st["prefill_dispatches"],
          "prefill_s": st["prefill_seconds"],
          "context_tok_per_s": st["prefill_tokens"] / st["prefill_seconds"],
          "decode_dispatches": st["decode_dispatches"],
          "decode_s": st["decode_seconds"],
          "generated_tokens": st["generated_tokens"],
          "generated_tok_per_s": st["generated_tokens"] / wall,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "upper_launches": upper, "two_level_launches": two,
          "combine_launches": combines,
          "occupancy": occ, "slot_lengths": lengths.tolist(),
          "slot_tokens_live": live.tolist(),
          "slot_level_tokens": {str(k): v.tolist() for k, v in level.items()},
          "slot_tail_tokens": tail.tolist()})
    outs = {len(q.prompt): q.out for q in done}
    if upper != cfg.num_layers * dispatches or two != 0:
        raise AssertionError(f"{upper} H-level launches (+{two} two-level) != "
                             f"{cfg.num_layers} x {dispatches} dispatches")
    if combines != want_comb:
        raise AssertionError(f"{combines} combine launches != {want_comb}")
    if int(bad) != 0:
        raise AssertionError(f"{int(bad)} non-finite logits")
    for n, t in zip(LONG["prompts"], LONG["new_tokens"]):
        o = outs[n]
        if len(o) != t or int(o.min()) < 0 or int(o.max()) >= cfg.vocab:
            raise AssertionError(f"stream of prompt {n} is short or out of vocab")
    if not (live <= LONG["max_len"]).all():
        raise AssertionError(f"live tokens {live} exceed the window")
    if occ["level2_entries"] <= 0 or occ["tail_tokens"] <= 0:
        raise AssertionError(f"the hierarchy stayed empty: {occ}")
    if not np.array_equal(held, lengths):
        raise AssertionError(f"tokens not conserved: live + levels + tail "
                             f"{held} != lengths {lengths}")
    return (upper, combines), eng


def phase_hier_parity(torch, chunk_attn):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.serve import EngineConfig, Request

    def h3(cfg):
        return cfg.replace(attention=cfg.attention.replace(levels=3))

    result = {}
    small = h3(get_smoke_config("qwen3-1.7b", activ_dtype="float32"))
    params = init_params(small, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=2, max_len=64, chunk=32)
    streams = [_streams(torch, chunk_attn, small, params, ecfg, _requests(
        Request, (200, 37, 150, 90), 24, small.vocab), plain)
        for plain in (False, True)]
    same = all(np.array_equal(streams[0][n], streams[1][n]) for n in streams[0])
    result["smoke"] = {"identical_streams": same, "requests": len(streams[0]),
                       "window": 64}
    if not same:
        raise AssertionError("H=3 smoke-size greedy streams differ kernel vs plain")
    del params

    full4 = h3(get_config("qwen3-1.7b", num_layers=4, activ_dtype="float32"))
    params = init_params(full4, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=2, max_len=4096, chunk=512)
    prompts = (16896, 3000)  # the first over 4x the window
    streams = [_streams(torch, chunk_attn, full4, params, ecfg, _requests(
        Request, prompts, 16, full4.vocab), plain) for plain in (False, True)]
    same = all(np.array_equal(streams[0][n], streams[1][n]) for n in streams[0])
    agree = np.mean([np.mean(streams[0][n] == streams[1][n])
                     for n in streams[0]])
    result["full_width_4_layers"] = {"prompts": list(prompts), "window": 4096,
                                     "identical_tokens": bool(same),
                                     "token_agreement": float(agree)}
    emit({"phase": "hier_parity", **result})
    if not same:
        raise AssertionError("H=3 full-width tokens differ kernel vs plain")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import mra_decode as tmd
    from repro_torch.kernels import block_sparse_attn as bsa
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
    bsa_err = phase_bsa_vs_plain(torch, bsa)
    bsa_time, dense_ms = phase_bsa_timing(torch, bsa)
    bsa_launches, state = phase_train_full_width(torch, bsa)
    phase_train_profile(torch, state)
    del state
    torch.cuda.empty_cache()
    phase_train_parity(torch, bsa)
    torch.cuda.empty_cache()
    up_err = phase_upper_vs_plain(torch, tmd, chunk_attn)
    up_time = phase_upper_timing(torch, tmd, chunk_attn)
    up_launches, eng = phase_long_context(torch, chunk_attn)
    phase_profile(torch, eng, C=LONG["chunk"], phase="long_context_profile")
    del eng
    torch.cuda.empty_cache()
    phase_hier_parity(torch, chunk_attn)
    dec = timing["decode"]
    print(smi, flush=True)
    train_kernels = []
    for name, key, line in (("bsa_fwd", "fwd", 92), ("bsa_bwd_dq", "dq", 196),
                            ("bsa_bwd_dkv", "dkv", 232)):
        t = bsa_time[key]
        train_kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/block_sparse_attn.cu",
            "replaces": f"src/repro/kernels/block_sparse_attn.py:{line}",
            "launches": bsa_launches[name], "max_abs_err": bsa_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
            "library_ms": None,
            "bound_ms_fp32_rate": t["bound_ms_fp32"],
            "bound_by_fp32_rate": t["bound_by_fp32"],
            "dense_sdpa_ms": dense_ms,
            "shape": "qwen3-1.7b train_4k, B=2, bf16, G=2",
            **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                                 "blocks_per_sm", "pairs_per_tile")}})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_fp32_rate",
            "bound_by_fp32_rate", "nsplit", "grid", "smem_bytes",
            "blocks_per_sm", "union_pages_per_tile")
    emit({"kernels": [{
        "name": "chunk_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_attn.cu",
        "replaces": "src/repro/kernels/chunk_attn.py:93",
        "launches": launches[0], "combine_launches": launches[1],
        "max_abs_err": max_err,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "bound_ms_fp32_rate": dec["bound_ms_fp32_rate"],
        "bound_by_fp32_rate": dec["bound_by_fp32_rate"],
        "nsplit": dec["nsplit"], "library_ms": None,
        "shape": "decode C=1 (latency), B=4; chunk128 below",
        "chunk128": {k: timing["chunk128"][k] for k in keys}}, {
        "name": "chunk_attn_upper", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_attn.cu",
        "replaces": "src/repro/kernels/chunk_attn.py:93 (with_upper=True)",
        "launches": up_launches[0], "combine_launches": up_launches[1],
        "max_abs_err": up_err,
        "ms": up_time["decode"]["ms"], "plain_ms": up_time["decode"]["plain_ms"],
        "bound_ms": up_time["decode"]["bound_ms"],
        "bound_by": up_time["decode"]["bound_by"],
        "bound_ms_fp32_rate": up_time["decode"]["bound_ms_fp32_rate"],
        "bound_by_fp32_rate": up_time["decode"]["bound_by_fp32_rate"],
        "nsplit": up_time["decode"]["nsplit"], "library_ms": None,
        "shape": "decode C=1 (latency), B=2, NU=33, L2-cold; chunk512 below",
        "two_level_ms": up_time["decode"]["two_level_ms"],
        "chunk512": {k: up_time["chunk512"][k] for k in
                     keys + ("two_level_ms",)}},
        *train_kernels]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
