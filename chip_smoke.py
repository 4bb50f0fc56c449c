#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port (``repro_torch``) on one card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into
``build/repro_torch/``, one nvcc per source, all at once, on a thread while
phases 28-30, which launch none of them, run first) and drives the port's
serving path and its training path on the card:

  1. device and build — the card's name and power limit, build seconds,
     and ptxas' registers and spill bytes of every chunk_attn (55) and
     bsa_* (54) kernel (a bf16 bsa_fwd / bsa_bwd_dq / bsa_bwd_dkv or bf16
     chunk_attn instantiation that spills fails);
  2. kernel vs plain version — every CUDA kernel against its plain PyTorch
     twin on the same CUDA tensors, at the main path's shapes and at the
     smoke config's, over decode/chunk widths, bf16/int8 caches, MRA-2 /
     MRA-2-s and dense/ring/ragged layouts, plus decode at the serving
     (B = 4) and long-context (B = 2) shapes with the split count forced to
     1, 2 and the planned one, and the speculative drafts' budget m = 1 at
     both under MRA-2 (C = 1, the split forced and planned, and C = 5; at
     long context with an H-level view of NU = 33), and granite-moe's
     (D, b) = (64, 128), G = 3 (decode with the split forced to 1 and
     planned, and C = 128), the G = 7 / 8 of qwen2-7b / yi-6b at
     (128, 128) and internvl2-1b's G = 7 at (64, 128) (atol 2e-5 / rtol
     1e-5 on rows whose top-m selection is no
     near tie; near ties under 1% of rows);
  3. kernel timing at the main path's shapes and at granite-moe's (D = 64,
     G = 3), beside its bound at the bf16 tensor-core and the fp32
     CUDA-core rate and the plain version's time, with the launch's split
     count, grid, shared memory, blocks per SM and the mean pages of a
     query tile's selection union;
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
     this script only): losses over 3 steps at the smoke size (1e-5), loss
     and grad norm of one step at full width (4 layers, 1e-4), all fp32;
 10. the chunk kernel's H-level program (``levels >= 3``: collapsed levels +
     tail folded into the background) against its plain twin on the same
     CUDA tensors: NU = 33 (H = 3) and 65 (H = 4) at the long-context
     slice's shapes, NU = 33 at granite-moe's (64, 128), NU = 5 and 40
     (three entry tiles) at the smoke shapes;
     C = 1, 512 and 5; bf16 / int8 caches; entries all live, some dead,
     all dead, tail only; ring windows and an empty one (slot 0: no live
     window key, live entries: not zero); MRA-2-s, where the view must not
     change the output; decode with the split count forced to 1, 2 and the
     planned one (same tolerance and near-tie rule as phase 2);
 11. its timing at the slice's shapes (decode and C = 512) beside the
     two-level program on the same window, both bounds, the plain version
     and the launch's split, grid, shared memory and occupancy;
 12. long-context serving at full width — qwen3-1.7b at ``levels=3``,
     LONG_LAYERS layers, bf16 activations, ``EngineConfig(slots=2, max_len=4096,
     chunk=512)``, a 65536-token and a 6000-token greedy prompt — with
     the H-level program's launches counted over exactly that run (and
     none of the two-level one; the combine's as in phase 4), the occupancy
     gauges and exact per-slot token conservation, then a torch.profiler
     breakdown of its prefill and decode dispatches;
 13. H = 3 engine parity — the plain version substituted for the kernel (in
     this script only): identical greedy streams at the smoke size with
     prompts far past the window, identical tokens at full width (4
     layers, fp32) with a prompt over 4x the window;
 14. speculative serving at full width — phase 4's engine and requests
     with ``spec_k=4`` (144 new tokens each): coarse-only drafts (budget
     m = 1, split decode), one (K+1)-chunk verify, ring rewinds, and plain
     fallback waves where a round would straddle the ring boundary. Rounds,
     acceptance, decode-side tokens per full-MRA dispatch against phase 4's,
     tok/s of both engines, chunk-kernel and combine launches by dispatch
     kind (each 28 x that kind's dispatches) and peak GiB; streams equal
     phase 4's, or leave them only where phase 4's top-2 logit gap is under
     4 bf16 ulps of its top logit; then a torch.profiler breakdown of one
     draft, one verify and one snapshot + rewind;
 15. speculative and telemetry parity on the card (smoke size, fp32): greedy
     spec_k = 3 streams equal the plain engine's at H = 2 and H = 3,
     telemetry on and off serve the same streams, and snapshot -> four
     draft steps -> rewind leaves every cache tensor (the hierarchy's at
     H = 3) bitwise as it was;
 16. (after phase 5) granite-moe-3b-a800m at full width — the MoE family's
     serving path: MOE_SERVE_LAYERS of its 32 layers, 40 experts top-8,
     head dim 64, random weights from a seed, fp32 parameters, bf16
     activations, phase 4's engine and prompts (``FAMILY_SERVE_TOKENS`` new
     tokens) — with tok/s, prefill / decode seconds, peak GiB and the chunk
     kernel's launches (layers x dispatches) and combines counted
     over exactly that run; then a torch.profiler breakdown of one decode
     and one prefill dispatch (the routed FFN's kernels apart, in a
     ``moe_block`` range);
 17. the experts' dropped-assignment share in those prefill dispatches,
     counted outside the timed run (the same prompts again, one new token
     each);
 18. granite-moe parity: greedy streams kernel vs plain at the smoke size,
     first tokens at full width (4 layers, fp32), and the whole-prompt
     ``prefill`` of one 4096-token prompt (the block-sparse forward at
     (64, 128), its launches counted) against ``prefill_chunk`` over the
     same prompt: layer 0's K/V and pyramid within 1e-5 of the tensor's
     largest magnitude, page table and lengths equal, at the served config
     and where the two are the same function (budgets covering the prompt,
     capacity_factor = E / top_k so no assignment drops); there the last
     logits of a one-layer pass within 1e-4, and every layer's cache error
     of the four-layer pass reported (``phase_moe_parity`` says why later
     layers part);
 19. (after phase 7) bsa_fwd at (64, 128), G = 3, against its plain twin,
     bf16 and fp32, twice and bit-identical, then timed at n = 4096, B = 1
     beside its bound and the plain version, with its grid, shared memory
     and blocks per SM (two or more in bf16, or the phase fails);
 22. (after phase 19) bsa_bwd_dq and bsa_bwd_dkv at (64, 128), G = 3, the
     same way, timed at granite-moe's training shape (B = 2, n = 4096);
 20. (after phase 9) granite-moe-3b-a800m training at full width — 32
     layers, 40 experts top-8, head dim 64, the preset's remat="full", seq
     4096, batch 2 (its peak under the card's 80 GiB, or the phase
     fails), three steps of ``train()`` from random weights — with
     loss, aux loss, grad norm, seconds, tok/s, peak GiB and the three
     kernels' launches counted over exactly that run; then a torch.profiler
     breakdown of one step (the routed FFN's forward and recompute in a
     ``moe_block`` range);
 21. granite-moe training parity, the plain versions substituted, fp32:
     losses over 3 smoke steps (1e-5); at full width one batch's loss, grad
     norm and every gradient leaf (1 layer), loss and grad norm (2 layers)
     within 1e-4, 4 layers reported (``MOE_PARITY`` says why); the plain
     route against a rerun of itself bitwise (loss and every gradient
     leaf) at all three depths; then remat "none", "full" and "dots" on
     the kernels at full width cut to 8 layers (one step each: loss and
     grad norm within 1e-6 of "none"'s, peak GiB, step seconds, launches;
     "full" twice, to tell whether reruns update every parameter bitwise
     alike);
 23. (after phase 22) bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at hubert-xlarge's
     (80, 128), G = 1 (B = 2, 16 heads, n = 4096, four blocks a row),
     non-causal and causal, bf16 and fp32, with and without padded keys /
     invalid pairs, against their plain twins at phase 22's tolerances,
     reruns bit-identical; then their times in bf16 beside the bounds and
     the plain twins, with grid, shared memory, blocks per SM and ptxas'
     registers and spills (fails under two blocks an SM in bf16 or on any
     spill of a D = 80 kernel);
 24. (after phase 21) hubert-xlarge at full width — 48 layers, 16 MHA heads
     of 80, non-causal, layernorm, gelu, learned positions, the audio-frame
     frontend: a forward of a ``make_batch`` frame batch, then one
     ``train()`` step at seq 4096 with the batch cut from 256 to
     ``FAMILY_BATCH`` (the largest power of two that fits), remat="full",
     launches counted over exactly that run, frames/s, peak GiB and a
     profiled step; then kernel against plain routes in fp32 at full width
     on one batch: loss, grad norm and every gradient leaf within 1e-4 at
     one layer, two layers reported;
 26. (after phase 23) bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at internvl2-1b's
     training call, (64, 128), G = 7 (B = 4, 14 / 2 heads, n = 4096,
     causal), bf16 and fp32, with and without padded keys / invalid pairs,
     against their plain twins at phase 22's tolerances, reruns
     bit-identical; then their times in bf16 beside the bounds and the
     plain twins, with grid, shared memory and blocks per SM (two or more
     in bf16, or the phase fails);
 25. internvl2-1b at full width — 24 layers, 14 query / 2 KV heads of 64
     (G = 7), the vision-patch frontend: the chunk kernel at G = 7 timed
     (decode and C = 128, as phase 3); three ``train()`` steps at seq 4096
     (256 patches + 3840 text tokens, batch cut as in phase 24), and kernel
     against plain routes in fp32 at full width on one batch (loss and
     grad norm within 1e-4 at one layer; the worst leaf and two layers
     reported); the whole-prompt ``prefill`` of 4 slots of 256 patches +
     3840 text tokens then 32 greedy ``decode_step``s, launches counted,
     kernels against plain twins at 2 layers (streams equal, or part only
     at a near tie by phase 14's rule), and at 4 and 24 layers reported
     beside the plain route against a rerun of itself and against itself
     on patches scaled by 1 + 2^-20; then phase 4's engine and text-only
     prompts, FAMILY_SERVE_TOKENS new tokens each (tok/s, prefill / decode
     seconds, peak GiB, chunk launches and combines).
 27. the paper's baselines on the reference's Fig. 4 / Tab. 7 inputs
     (``structured_qkv(default_rng(0), B=1, H=8, N=512, D=64)``, this
     script's own copy): each of the six on the card against the same call
     on the CPU (the same default draws) within 1e-4 of the output's
     largest magnitude, its ``rel_error`` against exact attention,
     Nyströmformer / Longformer / H-Transformer-1D within 1e-3 of the
     reference's rows (0.1706 / 0.5821 / 0.4121), H-Transformer-1D's exact
     term through one bsa_fwd launch at (64, 32); then bsa_fwd, bsa_bwd_dq
     and bsa_bwd_dkv at (64, 32), G = 1, non-causal, against their plain
     twins (bf16 and fp32, with and without padded keys / invalid pairs,
     reruns bit-identical), timed in bf16, ptxas per kernel;
 28. rwkv6-7b at full width — 32 layers, d_model 4096, 64 heads of 64,
     d_ff 14336, vocab 65536, 7.53 B fp32 parameters from a seed, bf16
     activations — served by phase 4's engine and requests through the
     recurrent state cache (the first stream runs past max_len): tok/s,
     prefill / decode seconds, peak GiB; then a torch.profiler breakdown
     of one decode and one prefill dispatch;
 29. rwkv6 against itself: ``wkv_chunked`` against ``wkv_scan`` at the
     full-width head shape (B = 2, 64 heads of 64, T = 4096, chunk 16;
     1e-4 of the output's largest magnitude), both timed; the
     whole-prompt ``prefill`` then decoding against stepwise decoding at 2
     full-width layers (the reference test's tolerances, held in fp32,
     bf16 reported); the greedy streams of a 2-layer full-width fp32
     engine on the card against the same engine on the CPU (equal, or
     parting only at an fp32 near tie);
 30. rwkv6 training at full width with the depth cut to RWKV_TRAIN_LAYERS
     (seq 4096, batch 2, the preset's remat="full", three ``train()``
     steps: seconds, tok/s, peak GiB; a profiled step; one layer more must
     run out of memory), and in fp32 at one full-width layer the chunked
     route's loss and grad norm against ``use_scan=True`` within 1e-4;
 31. (after phase 1) bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at
     recurrentgemma's (256, 128), G = 16 (B = 2, 16 query heads over one
     KV head, n = 4096, causal), bf16 and fp32, with and without padded
     keys / invalid pairs, against
     their plain twins at phase 22's tolerances, reruns bit-identical;
     then timed in bf16 beside the bounds and the plain twins, with grid,
     threads, shared memory, blocks per SM and ptxas per D = 256 kernel (a
     bf16 spill fails it);
 32. recurrentgemma-9b at full width — 38 layers in the (rglru, rglru,
     local) pattern, d_model 4096, 16 query heads over one KV head of 256,
     window 2048, vocab 256000, 8.53 B fp32 parameters from a seed, bf16
     activations — served by phase 4's engine and prompts
     (``FAMILY_SERVE_TOKENS`` new tokens) through the window ring + RG-LRU
     state (the two longest prompts wrap the ring):
     tok/s, prefill / decode seconds, peak GiB, occupancy; then a
     torch.profiler breakdown of one decode and one prefill dispatch;
 33. (after phase 31, before phase 2: its peak leaves the least room, so
     it runs on an unfragmented cache, with expandable segments) its MRA-2
     variant (b = 128, four blocks a row) through ``train()`` at full width
     with the depth cut to RGEMMA_TRAIN_GROUPS whole groups
     (seq 4096, batch 2, remat="full", three steps, launches exact); a
     profiled step; one group more must run out of memory; one step of the
     preset's ``local`` kind (no kernel launched); kernel against plain
     routes in fp32 on one batch: loss, grad norm and every gradient leaf
     within 1e-4 at one group, two groups reported;
 34. recurrentgemma against itself: the RG-LRU doubling scan against a
     sequential loop at (B, T, W) = (2, 4096, 4096) (1e-4 of the largest
     magnitude), both timed; the whole-prompt ``prefill`` then stepwise
     ``decode_step`` at one group (the reference test's tolerances, fp32
     held, bf16 reported); the MRA-2 variant's whole-prompt ``prefill``
     of a 4096-token prompt on one bsa_fwd launch against the plain twin
     (1e-4); card vs CPU greedy streams of a one-group fp32 engine with
     the window cut to 128 (equal, or parting only at an fp32 near tie).

 11b. (after phase 11) the H-level program timed the same way at
     granite-moe's (D, b) = (64, 128), G = 3 (``UP_GRANITE``).
 35. (last) a (data, model) = (2, 2) mesh of four ranks spawned on the one
     card (``launch.mesh.spawn``, gloo: NCCL refuses two ranks on one
     device; every collective on a CUDA tensor staged through host
     memory by ``distributed/collectives.py``), after the kernels are
     built and the one-device references computed here: the collective
     probe (backend, staged ops, each collective's value on CUDA tensors);
     qwen3-1.7b at full width, 2 layers, fp32: one batch's loss and grad
     norm within 1e-4 of one device and every gradient block within 5e-3
     (the reference's shard-tier bound), and phase 4's requests through
     the mesh engine (``MESH_NEW_TOKENS`` new tokens) with streams equal
     to the one-device engine's;
 36. qwen3-1.7b's bf16 ``train()`` on the mesh at MESH_TRAIN_LAYERS layers
     (seq 4096, batch 2: one row a data rank, remat="full",
     MESH_TRAIN_STEPS steps): per rank the step seconds, peak GiB, the
     kernels' launches (exact) with the local shape of every launch (4 of
     8 KV heads), the collectives' bytes a step and the share of wall
     time their host staging takes; the last step's loss and grad norm
     agree across the ranks and, after the ZeRO-1 updates (moment shards,
     then the parameter slices all-gathered over "data"), every parameter
     block's bit checksum agrees across the data ranks that hold it;
     then the full-depth mesh engine on
     one of phase 4's requests (MESH_DEEP_PROMPT; launches = 28 x
     dispatches a rank, 2 slots and 4 KV heads a launch), its stream
     against phase 4's (the first token where they part, reported);
 37. granite-moe-3b-a800m on the mesh (40 experts: 20 a model rank): one
     fp32 MoE layer's forward and backward under ``psum`` and ``a2a``
     within 1e-3 of the local path (capacity E / top_k: nothing drops),
     phase 4's requests through a 2-layer fp32 mesh engine with that
     capacity (streams equal to one device's), and one of phase 4's
     prompts through its mesh engine at phase 16's MOE_SERVE_LAYERS (its
     stream against phase 16's, reported: capacity counts each data
     rank's rows).
 38. rwkv6-7b on the mesh (the time mix's 64 heads and the channel mix's
     d_ff split over "model", the wkv state's heads too): at 2 full-width
     layers in fp32 one batch's loss and grad norm within 1e-4 of one
     device and every gradient block within 5e-3, and phase 4's requests
     through the mesh engine with streams equal to one device's; one bf16
     ``train()`` step at MESH_RWKV_TRAIN_LAYERS layers (step seconds,
     tok/s, peak GiB a rank and on the card, collective bytes, staging
     share); the bf16 mesh engine at MESH_RWKV_SERVE_LAYERS layers on
     MESH_DEEP_PROMPT (its stream against phase 28's, reported);
 39. recurrentgemma-9b on the mesh (the RG-LRU whole and its state on the
     rank's slots, the MLP and vocab split, the one KV head's window ring
     on the rank's slots): at MESH_RGEMMA_GROUPS full-width group in fp32
     the gradients held as phase 38's, for the ``local`` kind and the
     MRA-2 variant, whose bsa_fwd / bsa_bwd_dq / bsa_bwd_dkv launch on every
     rank's rows at (256, 128) (launches exact) and hold against the plain
     twins on the mesh (loss, grad norm, every leaf 1e-4); phase 34's
     requests (the window cut to 128: the two longest wrap the ring)
     through the fp32 mesh engine, streams equal to one device's; the bf16 mesh engine at
     MESH_RGEMMA_SERVE_GROUPS groups on MESH_DEEP_PROMPT, reported.
 40. the chunk kernel at hubert-xlarge's (80, 128), G = 1, both programs,
     bf16 / fp32 / int8 caches, decode and C = 128 / 5, against its plain
     twin (the serving tolerance), two blocks an SM for each program, the
     workspace program forced equal bit for bit to the shared-memory one,
     its time; then the hubert engine at full width (16 of 48 layers) and its
     fp32 2-layer greedy streams equal to the plain route's;
 41. the chunk kernel at 4096 pages (LONG_PAGES: qwen2-7b's G = 7 decode,
     qwen3-1.7b's C = 128 chunk), which plan its workspace program, held
     and timed;
 42-44. the reference's shape cells at qwen3-1.7b's full width through the
     normal entry points: ``prefill_32k`` (``transformer.prefill``,
     bsa_fwd at n = 32768), ``decode_32k`` (slots filled by ``prefill``,
     then ``decode_step`` over 256 pages) and ``long_500k`` (prefill of
     524,288 tokens, then decode over 4096 pages), each under the cut
     (batch, int8 KV, bf16 weights, depth) the dry run picks from
     CELL_CUTS to fit CELL_GIB; each prints the dry run's predicted peak,
     FLOPs and roofline time beside the card's peak, wall, device time and
     busy share and the kernels' launches, and fails where the peak lands
     more than CELL_PEAK_TOL from the prediction; one layer's kernels at
     the new sizes are held against their plain twins first;
 45. ``repro_torch.examples.train_lm`` at its small preset for
     TRAIN_LM_STEPS steps, its kernels' call held first.
 46. (after phase 41) the chunk kernel's H-level program past shared
     memory (UPPER_WS: qwen2-7b's G = 7 C = 128 chunk at 512 pages,
     qwen3-1.7b's C = 128 chunk at 1000 and its decode at 6448, bf16 and
     the decode in int8) against its plain twin at the serving tolerance,
     timed, with its workspace program's shared memory, workspace bytes,
     blocks per SM and split; at phase 11's shapes the workspace program
     forced beside the shared one, bit for bit, both timed;
 47. the chunk kernel at kimi-k2's (112, 128), G = 8, both programs, bf16 /
     fp32 / int8, decode and C = 128 / 5, dense / ring / ragged, MRA-2 and
     MRA-2-s, the workspace program at 4096 pages (decode) and 1024 (C =
     128), against its plain twin; ptxas and blocks an SM of all twelve
     D = 112 programs (two an SM, no bf16 spill); timed;
 48. (after phase 26) bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at (112, 128),
     64 query / 8 KV heads, n = 4096, causal, bf16 and fp32, against their
     plain twins, reruns bit-identical; timed, ptxas per kernel;
 49. (after phase 33) kimi-k2-1t-a32b at full width, one of its 61 layers,
     bf16 weights (384 experts top-8, head dim 112): KIMI's two greedy
     requests through the engine (launches = layers x dispatches), a
     profile of its dispatches and a whole-prompt ``prefill`` of the
     longest prompt (bsa_fwd at (112, 128)); one captured chunk-kernel
     call and the bsa_fwd call held against their plain twins (the
     tolerances plus the fp32 rounding of the largest attended score:
     its seeded logits reach ~1e3), tokens and MoE assignments conserved,
     tok/s, the dropped-assignment share and the init's and run's peaks;
 50. (after phase 15) the grouped far-field draft: the fold (group sizes 2
     and 4) against its plain twin at the drafts' budget m = 1 and m = 16,
     with and without an H-level view, over layouts, caches and splits; a
     draft call's time at draft_level 1 and 2; phase 14's speculative
     engine at ``levels=3`` (SPEC_DRAFT_LAYERS layers) at draft_level 1
     and 2 against plain decoding (streams equal, or parting only at a
     near tie by phase 14's rule), acceptance and tokens per full
     dispatch.

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
import warnings
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
ATOL, RTOL, TIE = 2e-5, 1e-5, 1e-4
MAIN = dict(B=4, Hkv=8, G=2, D=128, b=128, nb=32, m=16)  # qwen3-1.7b serving
SMOKE = dict(B=4, Hkv=2, G=2, D=16, b=16, nb=4, m=2)     # its smoke config
# granite-moe-3b-a800m serving (head dim 64 at block 128, G = 3), and the
# query-head groups of qwen2-7b (G = 7) and yi-6b (G = 8) at 4 KV heads
GRANITE = dict(B=4, Hkv=8, G=3, D=64, b=128, nb=32, m=16)
GROUPS = (("qwen2-7b", dict(B=4, Hkv=4, G=7, D=128, b=128, nb=32, m=16)),
          ("internvl2-1b", dict(B=4, Hkv=2, G=7, D=64, b=128, nb=32, m=16)),
          ("yi-6b", dict(B=4, Hkv=4, G=8, D=128, b=128, nb=32, m=16)))
WIDTHS = ((1, "latency"), (128, "throughput"), (5, "throughput"))
# the long-context slice (levels=3): 2 slots of 4096-token windows; NU
# collapsed entries per (batch, kv-head) row: 32 per level + the tail
UP_MAIN = dict(B=2, Hkv=8, G=2, D=128, b=128, nb=32, m=16)
# speculative drafts run the serving shapes at the budget m = 1
DRAFT_MAIN, DRAFT_UP = dict(MAIN, m=1), dict(UP_MAIN, m=1)
UP_CASES = (("main", UP_MAIN, 33), ("main", UP_MAIN, 65),
            ("smoke", SMOKE, 5), ("smoke", SMOKE, 40),
            ("granite", dict(GRANITE, B=2), 33))
UP_WIDTHS = ((1, "latency"), (512, "throughput"), (5, "throughput"))
UP_PATTERNS = ("all_live", "some_dead", "all_dead", "tail_only")
L2_COPIES = 4  # cache copies cycled by the H-level timing (> 50 MB L2)
# granite-moe's long-context slice, (D, b) = (64, 128): the H-level
# program's second built shape, timed as UP_MAIN is (phase 11b)
UP_GRANITE = dict(GRANITE, B=2)
LONG = dict(slots=2, max_len=4096, chunk=512, prompts=(65536, 6000),
            new_tokens=(8, 64))
LONG_LAYERS = 4  # the long-context engine's depth (of 28: cut for time)
# block-sparse attention of qwen3-1.7b train_4k (batch cut to 2) and of its
# smoke config; Hq query heads, G per KV head
BSA_MAIN = dict(B=2, Hq=16, n=4096, d=128, b=128, bpr=4)
BSA_SMOKE = dict(B=2, Hq=4, n=256, d=16, b=16, bpr=2)
# phase 6's further cases (G = 2, bf16 and fp32): a hot key tile at the main
# shapes, and the smoke shapes at a head dim the kernels zero-pad (12 -> 16)
BSA_EXTRA = (("main-hot", BSA_MAIN, True), ("smoke-d12", dict(BSA_SMOKE, d=12),
                                            False))
# granite-moe's whole-prompt prefill: the forward alone at (d, b) = (64, 128),
# 24 query heads over 8 KV heads, one 4096-token prompt
BSA_GRANITE = dict(B=1, Hq=24, n=4096, d=64, b=128, bpr=4)
# hubert-xlarge's block-sparse call: 16 MHA heads of 80 (G = 1), batch 2,
# n = 4096, four blocks a row; held non-causal (hubert's) and causal
BSA_HUBERT = dict(B=2, Hq=16, n=4096, d=80, b=128, bpr=4)
# internvl2-1b's training call at its batch cut (4): 14 query heads over 2 KV
# heads (G = 7, the widest dk/dv sum the kernels carry), causal
BSA_VLM = dict(B=4, Hq=14, n=4096, d=64, b=128, bpr=4)
# fp32 sums in another order and FMA contraction: normalized numerator and
# max-scaled gradients at rtol/atol 1e-4, the stabilizer mt at abs 1e-5
BSA_TOL, MT_TOL = 1e-4, 1e-5
TRAIN = dict(seq=4096, batch=2, steps=3)  # train_4k with the batch cut to 2
# granite-moe-3b-a800m's training parity at full width (phase 21): per
# depth, what is held to the plain versions within 1e-4. Without qk-norm each
# layer's backward amplifies the rounding of the one after it: at 4 layers
# the kernels' fp32 sums in another order part from the plain route by
# ~2e-4 in the grad norm and by ~1e-1 in the worst leaf, while the plain
# route reruns bitwise; so 4 layers are reported and not held
MOE_PARITY = ((1, ("loss_rel", "grad_norm_rel", "leaf_rel")),
              (2, ("loss_rel", "grad_norm_rel")), (4, ()))
# phase 21 compares the remat policies at full width with the depth cut to
# MOE_REMAT_LAYERS
MOE_REMAT_LAYERS = 8
# the serving engine's traffic (phase 4), and phase 14's speculative run of
# the same requests: new tokens cut from 192 to 144 to hold the script's
# time, still past the 4096-token ring (3968 + 144), so fallback waves run
SERVE = dict(prompts=(3968, 2500, 1200, 300), new_tokens=144)
# the other families' engines on the same prompts (granite-moe, internvl,
# recurrentgemma): new tokens cut from 192, then from 96, for the script's
# time
FAMILY_SERVE_TOKENS = 64
SPEC = dict(spec_k=4, new_tokens=144)
# granite-moe-3b-a800m at full width: phase 4's engine and requests
MOE_ARCH = "granite-moe-3b-a800m"
MOE_SERVE_LAYERS = 16  # granite's engines, one device and mesh (of 32: time)
# the hubert encoder and the internvl VLM at full width (phases 24-25):
# train_4k (seq 4096; internvl: 256 patches + 3840 text tokens) with the
# batch cut from 256 to the largest power of two whose steps fit the card;
# the phases show that twice the batch runs out of memory
HUBERT_ARCH, VLM_ARCH = "hubert-xlarge", "internvl2-1b"
FAMILY_BATCH = {HUBERT_ARCH: 64, VLM_ARCH: 4}
# train() steps at the batch cut (hubert's ~12 s steps cut from three)
FAMILY_STEPS = {HUBERT_ARCH: 1, VLM_ARCH: TRAIN["steps"]}
# whether the profiled step runs once more without the profiler for its
# wall (_profile's ``alone``): not hubert's ~12 s step, where the
# profiler's own cost is small
FAMILY_PROFILE_ALONE = {HUBERT_ARCH: False, VLM_ARCH: True}
# internvl2-1b's serving: 14 query / 2 KV heads (G = 7) at (64, 128)
VLM_SERVE = dict(B=4, Hkv=2, G=7, D=64, b=128, nb=32, m=16)
# the whole-prompt prefill of 4 slots of 256 patches + 3840 text tokens,
# then 32 greedy decode steps in a window one block longer than the prompt
VLM_PROMPT = dict(slots=4, text=3840, new_tokens=32, max_len=4096 + 128)
# the depth at which phase 25 holds those greedy streams kernel vs plain,
# and the deeper ones it reports beside full depth. MRA-2's top-k block
# and page selections are discrete, so a rounding difference that flips a
# near-tied selection changes a row by O(1), and at the preset's random
# initialization that grows layer by layer: from 4 layers on the plain
# route parts from itself at the first tokens when its patches are scaled
# by 1 + VLM_PERTURB (under half a bf16 ulp: it moves only the inputs near
# a rounding boundary), as kernel and plain part there; at 2 layers they
# part at near ties only
VLM_PARITY_LAYERS, VLM_REPORT_LAYERS, VLM_PERTURB = 2, (4,), 2.0 ** -20
# internvl's fp32 kernel-vs-plain training parity at one layer holds loss,
# grad norm and every gradient leaf (the leaf held once the fp32 kernels'
# scores took the plain product's order: 1.19e-4 before, 3.08e-6 after)
VLM_PARITY_HELD = ("loss_rel", "grad_norm_rel", "leaf_rel")
# whole-prompt prefill vs prefill_chunk (tests/test_torch_transformer.py's
# tolerances): logits atol, cache entries within this share of the tensor's
# largest magnitude
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
# dispatches a serving profile averages (phases 4, 16, 12, 28, 32): cut from
# 10 decode / 3 prefill, then from 4 / 2, to keep the script inside its
# time limit (the profiler's event processing, not the dispatches, takes
# the time)
PROFILE_STEPS = dict(decode=2, prefill=1)
# the paper's baselines (phase 27) on the reference's Fig. 4 / Tab. 7
# inputs, the deterministic three's rel_error rows of BENCH_063798c.json,
# and the block-sparse kernels at H-Transformer-1D's call (head dim 64,
# block 32, three blocks a row, non-causal)
BASELINE = dict(B=1, H=8, N=512, D=64)
BASELINE_KINDS = ("linformer", "performer", "nystromformer", "longformer",
                  "bigbird", "h_transformer_1d")
BASELINE_REF = {"nystromformer": 0.1706, "longformer": 0.5821,
                "h_transformer_1d": 0.4121}
BSA_H1D = dict(B=1, Hq=8, n=512, d=64, b=32, bpr=3)
# rwkv6-7b (phases 28-30): wkv_chunked against wkv_scan at the full-width
# head shape; training at seq 4096 with the depth cut to the largest layer
# count whose fp32 weights, gradients and AdamW moments (16 bytes a
# parameter) fit beside the activations (phase 30 shows one more does
# not); the scan route's fp32 gradient check at a shorter sequence (its
# autograd keeps every step's state); the card-vs-CPU greedy streams at 2
# layers on short prompts (the CPU serves them too)
RWKV_ARCH = "rwkv6-7b"
RWKV_WKV = dict(B=2, H=64, dh=64, T=4096, chunk=16)
RWKV_TRAIN_LAYERS = 18
RWKV_SCAN_SEQ = 1024
RWKV_STREAMS = dict(prompts=(301, 160, 64, 17), new_tokens=16)
# recurrentgemma-9b (phases 31-34). Its MRA-2 variant takes the MRA presets'
# parameters (b = 128, four blocks a row): its local layers run the
# block-sparse kernels at (256, 128), 16 query heads over one KV head
RGEMMA_ARCH = "recurrentgemma-9b"
RGEMMA_MRA = dict(kind="mra2", block_size=128, blocks_per_row=4)
BSA_RGEMMA = dict(B=2, Hq=16, n=4096, d=256, b=128, bpr=4)
# training's depth cut: the most whole (rglru, rglru, local) groups whose
# fp32 weights, gradients and AdamW moments (16 bytes a parameter) fit
# beside the embeddings (2.10 B parameters) and the 256,000-wide logits
# (with expandable segments: see _expandable_segments)
RGEMMA_TRAIN_GROUPS = 2
RGEMMA_PARITY_BATCH = 1  # fp32 parity: two gradient sets beside the logits
RGEMMA_SCAN = dict(B=2, T=4096, W=4096)  # the RG-LRU scan at full width
RGEMMA_PREFILL = 4096  # the MRA-2 variant's whole-prompt prefill
# card vs CPU streams at one group, the window cut so the prompts wrap it
RGEMMA_STREAMS = dict(prompts=(301, 160, 64, 17), new_tokens=16, window=128)
# the chunk kernel at hubert-xlarge's serving shape (phase 40): head dim 80
# at block 128, 16 KV heads of one query head each, 4096-token slots
HUBERT_SERVE = dict(B=4, Hkv=16, G=1, D=80, b=128, nb=32, m=16)
HUBERT_SERVE_TOKENS = 32  # its full-width engine's new tokens a request
HUBERT_SERVE_LAYERS = 16  # and its depth (of 48: cut for time)
# the reference's shape cells (phases 42-44) at qwen3-1.7b's full width, 28
# layers: each cell's cut is the first of its candidates whose peak the dry
# run (launch/dryrun.py, one rank) predicts under CELL_GIB of the card's
# 79.2; the card's peak must land within CELL_PEAK_TOL of the prediction.
# decode_32k fills its slots by whole-prompt prefill, ``fill`` at a time.
SHAPE_ARCH = "qwen3-1.7b"
CELL_GIB, CELL_PEAK_TOL = 72.0, 0.15
CELL_CUTS = {
    "prefill_32k": (dict(batch=16), dict(batch=8), dict(batch=4)),
    "decode_32k": (dict(batch=32, fill=2), dict(batch=16, fill=2),
                   dict(batch=8, fill=2)),
    "long_500k": (dict(batch=1), dict(batch=1, kv_quant=True),
                  dict(batch=1, kv_quant=True, param_dtype="bfloat16"),
                  dict(batch=1, kv_quant=True, param_dtype="bfloat16",
                       layers=14)),
}
CELL_STEPS = 6  # greedy decode steps after the timed and profiled one
# examples/train_lm.py on the card (phase 45): its small preset's steps, and
# its kernels' call (batch 8, seq 256, 8 query / 4 KV heads of 32, block 32)
TRAIN_LM_STEPS = 3
TRAIN_LM_BSA = dict(B=8, Hq=8, n=256, d=32, b=32, bpr=4)
# the chunk kernel at 4096 pages of 128 tokens (long_500k's 524,288; phase
# 41), one slot: where its page arrays leave shared memory for the
# workspace program (qwen2-7b's G = 7 decode, qwen3-1.7b's C = 128 prefill
# chunk), and the long_500k cell's own decode (qwen3-1.7b, G = 2, int8
# cache), which still fits shared memory; (label, arch, shape, C, mode,
# the timed cache type, the program expected)
LONG_PAGES = (
    ("qwen2-7b decode", "qwen2-7b", dict(B=1, Hkv=4, G=7, D=128, b=128,
                                         nb=4096, m=16), 1, "latency",
     "bf16", True),
    ("qwen3-1.7b chunk128", "qwen3-1.7b", dict(B=1, Hkv=8, G=2, D=128, b=128,
                                               nb=4096, m=16), 128,
     "throughput", "bf16", True),
    ("qwen3-1.7b decode", "qwen3-1.7b", dict(B=1, Hkv=8, G=2, D=128, b=128,
                                             nb=4096, m=16), 1, "latency",
     "int8", False))
# the H-level program past shared memory (phase 46): qwen2-7b's G = 7
# C = 128 chunk at a 512-page ring, qwen3-1.7b's C = 128 chunk at 1000 pages
# and its decode at 6448 pages, one slot, NU collapsed entries; (label,
# shape, C, mode, cache types held; bf16 plans the workspace program)
UPPER_WS = (
    ("qwen2-7b C=128 nb=512", dict(B=1, Hkv=4, G=7, D=128, b=128, nb=512,
                                   m=16), 128, "throughput", ("bf16",)),
    ("qwen3-1.7b C=128 nb=1000", dict(B=1, Hkv=8, G=2, D=128, b=128, nb=1000,
                                      m=16), 128, "throughput", ("bf16",)),
    ("qwen3-1.7b decode nb=6448", dict(B=1, Hkv=8, G=2, D=128, b=128,
                                       nb=6448, m=16), 1, "latency",
     ("bf16", "int8")))
UPPER_WS_NU = 33
# kimi-k2-1t-a32b (phases 47-49): head dim 112 at block 128, 64 query over
# 8 KV heads (G = 8); its serving kernel at 4096-token slots, at 4096
# pages (decode) and 1024 (a C = 128 chunk) where the workspace program
# takes the page arrays, and its block-sparse call at train_4k's n
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_SERVE = dict(B=2, Hkv=8, G=8, D=112, b=128, nb=32, m=16)
KIMI_PAGES = ((1, "latency", dict(KIMI_SERVE, B=1, nb=4096)),
              (128, "throughput", dict(KIMI_SERVE, B=1, nb=1024)))
BSA_KIMI = dict(B=1, Hq=64, n=4096, d=112, b=128, bpr=4)
# one full-width layer in bf16 weights (~17 G expert parameters + the
# 163840 x 7168 embedding and head: 38.8 GB) through the engine and a
# whole-prompt prefill of its longest prompt
KIMI = dict(layers=1, slots=2, max_len=4096, chunk=128, prompts=(3968, 1200),
            new_tokens=32)
# the grouped far-field draft (phase 50): phase 14's speculative engine at
# levels=3, the depth cut to SPEC_DRAFT_LAYERS, drafts at draft_level 1
# and 2 against plain decoding at levels=3; the fold kernel held at group
# sizes 2 and 4
SPEC_DRAFT_LAYERS = 4
DRAFT_LEVELS = (2, 3)


START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:  # seconds since the script started, for its budget
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------- #
# kernel inputs, selection margins and bounds
# --------------------------------------------------------------------------- #
def kernel_case(torch, tmd, seed, sh, C, layout, dtype):
    """(pre, k, v, q_pos, ks, vs) for one comparison, from ``seed``;
    ``dtype`` the cache's: bf16, int8 or fp32.

    Keys carry a random per-page offset so coarse scores spread like real
    attention. layout: dense (full slots) | ring (a 1.5x-capacity stream
    through the ring) | ragged (random lengths, slot 0 empty).
    """
    from repro_torch.core.mra import MraConfig

    r = np.random.default_rng(seed)
    B, Hkv, G, D, b, nb = (sh[k] for k in ("B", "Hkv", "G", "D", "b", "nb"))
    S = nb * b
    cu = DEVICE
    # the normals drawn on the device from the seed (numpy's took most of
    # phase 2's time); the layouts' integers from numpy's
    g = torch.Generator(device=cu)
    g.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=cu, dtype=torch.float32)

    k = normal(B, Hkv, S, D) + normal(B, Hkv, nb, D).repeat_interleave(b, 2)
    v = normal(B, Hkv, S, D)
    q = normal(B, Hkv * G, C, D)
    pb = np.tile(np.arange(nb, dtype=np.int32), (B, 1))
    if layout == "ring":
        lengths = np.full((B,), S + S // 2)
        pb = np.roll(pb + nb // 2, nb // 2, axis=1).astype(np.int32)
    elif layout == "ragged":
        lengths = np.concatenate([[0], r.integers(1, S + 1, B - 1)])
    else:
        lengths = np.full((B,), S)
    q_pos = np.maximum(lengths[:, None] - C, 0) + np.arange(C)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=cu)
    pb = torch.from_numpy(pb).to(cu)
    ks = vs = None
    if dtype == "int8":
        k, ks = tmd.quantize_kv(k)
        v, vs = tmd.quantize_kv(v)
        kf, vf = k.float() * ks[..., None], v.float() * vs[..., None]
    elif dtype == "fp32":
        kf, vf = k, v
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        kf, vf = k.float(), v.float()
    mask = tmd.paged_position_mask(lengths, pb, S, b).float()[:, None, :, None]
    pyr = tmd.PyramidState((kf * mask).reshape(B, Hkv, nb, b, D).sum(3),
                           (vf * mask).reshape(B, Hkv, nb, b, D).sum(3))
    q_pos = torch.as_tensor(q_pos, dtype=torch.int32, device=cu)
    pre = tmd._chunk_prelude(q, k, v, lengths, q_pos,
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
    """Least time for this call: ``kernels/cost.py``'s bytes (each input
    read once, the output written once; the K/V pages of the selection's
    union) over HBM bandwidth vs its operations over the bf16 tensor-core
    rate and over the fp32 CUDA-core rate; ``nu`` collapsed entries (the
    H-level program) add their means, counts, scores and fold. Returns a
    dict with ``bound_ms`` / ``bound_by`` at the bf16 rate,
    ``bound_ms_fp32_rate`` / ``bound_by_fp32_rate``, ``bytes`` and
    ``flops``."""
    from repro_torch.kernels import cost

    B, Hkv, G, C, D = pre.qg.shape
    union = int(grid.any(3).any(2).sum())  # (B, Hkv, nb) pages read at all
    out = cost.chunk_cost(B, Hkv, G, C, D, pre.block_size, pre.pb.shape[1],
                          k.element_size(), ks is not None, union, pairs, nu)
    for key, rate in (("", cost.BF16_FLOP_PER_S),
                      ("_fp32_rate", cost.FP32_FLOP_PER_S)):
        out[f"bound_ms{key}"], out[f"bound_by{key}"] = cost.bound_ms(
            out["bytes"], out["flops"], rate)
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
def start_build():
    """``build.build_all()`` on a thread (each nvcc is a child process), so
    the phases that launch no kernel of this repo run on the card while it
    compiles; ``phase_device`` joins it. Until then a kernel wrapper's
    ``load_library`` raises instead of starting a second nvcc."""
    import threading

    from repro_torch.kernels import build

    job = {"t0": time.perf_counter()}

    def run():
        try:
            job["libs"] = build.build_all()
        except BaseException as e:  # re-raised by phase_device
            job["error"] = e
        job["build_s"] = time.perf_counter() - job["t0"]

    def refuse(name):
        raise RuntimeError(f"{name}: a kernel launched before the build was "
                           "joined")

    job["thread"] = threading.Thread(target=run, name="nvcc", daemon=True)
    job["guard"] = mock.patch.object(build, "load_library", refuse)
    job["guard"].start()
    job["thread"].start()
    return job


def join_build(job):
    """Wait for ``start_build``'s compilers and lift the guard."""
    job["thread"].join()
    guard = job.pop("guard", None)
    if guard is not None:
        guard.stop()


def phase_device(torch, job):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    join_build(job)
    if "error" in job:
        raise job["error"]
    libs, build_s = job["libs"], job["build_s"]
    wait_s = time.perf_counter() - t0
    bsa_ptx = ptxas_report(
        libs["block_sparse_attn"].with_suffix(".log").read_text())
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_wait_s": wait_s,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "ptxas_chunk_attn": ptxas_report(
              libs["chunk_attn"].with_suffix(".log").read_text()),
          "ptxas_block_sparse_attn": bsa_ptx})
    # 54 = bf16 and fp32 x nine (D, b) x bsa_fwd, bsa_bwd_dq, bsa_bwd_dkv
    spills = [k for k in bsa_ptx if k["kernel"].startswith(
        ("bsa_fwd bf16", "bsa_bwd_dq bf16", "bsa_bwd_dkv bf16"))
        and (k["spill_stores"] or k["spill_loads"] or k["registers"] > 255)]
    if len(bsa_ptx) != 54 or spills:
        raise AssertionError(f"bsa kernels: {len(bsa_ptx)} built, spilling "
                             f"bf16 tensor-core kernels {spills}")
    # 55 = three storage types x (five (D, b) x two programs + both
    # programs' workspace variants at the four of block 128), + the combine
    chunk_ptx = ptxas_report(libs["chunk_attn"].with_suffix(".log").read_text())
    spills = [k for k in chunk_ptx if k["kernel"].startswith("bf16")
              and (k["spill_stores"] or k["spill_loads"])]
    if len(chunk_ptx) != 55 or spills:
        raise AssertionError(f"chunk_attn kernels: {len(chunk_ptx)} built, "
                             f"spilling bf16 instantiations {spills}")
    return smi, bsa_ptx, chunk_ptx


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
    upper, ws = (b == "1" for b in re.findall(r"Lb([01])E", name))
    shape = " ".join(f"{k}={v}" for k, v in zip("Db", dims)) or "D=?"
    return (f"{dt} {shape} {'upper' if upper else 'two_level'}"
            + (" workspace" if ws else ""))


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


def _hold(torch, tmd, got, pre, q_pos, m, ref, label, atol=ATOL):
    """(max |err| outside near ties, near-tie rows, rows) of kernel vs plain;
    raises on a disagreement outside the near ties or a non-finite value."""
    margin, _, _ = selection_stats(torch, tmd, pre, q_pos, m)
    tie = (margin < TIE).reshape(got.shape[:3])[..., None]
    close = torch.isclose(got, ref, atol=atol, rtol=RTOL) | tie
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
    # the speculative drafts' budget m = 1 (own block only): decode with the
    # split forced and planned, and a verify-width chunk; at long context
    # with the H-level view (NU = 33) attached
    cases += [(("main-m1", DRAFT_MAIN), (1, "latency"), ns)
              for ns in (1, 2, "plan")]
    cases += [(("main-m1", DRAFT_MAIN), (5, "throughput"), None)]
    cases += [(("long-m1", DRAFT_UP), (C, mode), None)
              for C, mode in ((1, "latency"), (5, "throughput"))]
    # granite-moe (64, 128), G = 3: decode with the split forced to 1 and
    # planned, and its prefill chunk; qwen2-7b's and yi-6b's 7 and 8 heads
    cases += [(("granite", GRANITE), (1, "latency"), ns) for ns in (1, "plan")]
    cases += [(("granite", GRANITE), (128, "throughput"), None)]
    cases += [((name, sh), (C, mode), None) for (name, sh), (C, mode)
              in itertools.product(GROUPS, ((1, "latency"),
                                            (128, "throughput")))]
    by_shape = {}
    forced = budget_one = 0
    for (name, sh), (C, mode), nsplit in cases:
        # the drafts run MRA-2 (the background on); tests/test_torch_cuda.py
        # holds m = 1 under MRA-2-s too
        variants = ("full",) if sh["m"] == 1 else ("full", "sparse")
        for layout, dtype, variant in itertools.product(
                ("dense", "ring", "ragged"), ("bf16", "int8"), variants):
            n += 1
            pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + n, sh, C,
                                                   layout, dtype)
            if name == "long-m1":
                pre = pre._replace(upper=upper_view(
                    torch, SEED + 2000 + n, sh["B"], sh["Hkv"], sh["D"], 33,
                    "all_live"))
            budget_one += sh["m"] == 1
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
            by_shape[name] = max(by_shape.get(name, 0.0), err)
    emit({"phase": "kernel_vs_plain", "kernel": "chunk_attn", "cases": n,
          "forced_split_cases": forced, "forced_nsplit": [1, 2, "plan"],
          "budget_one_cases": budget_one,
          "atol": ATOL, "rtol": RTOL, "max_abs_err": worst,
          "max_abs_err_by_shape": by_shape,
          "near_tie_rows": ties, "rows": rows, "tie_margin": TIE})
    if ties > 0.01 * rows:
        raise AssertionError(f"{ties} near-tie rows of {rows} exceed 1%")
    return worst, by_shape


def phase_timing(torch, tmd, chunk_attn, sh=MAIN, arch="qwen3-1.7b"):
    out = {}
    for label, C, mode in (("decode", 1, "latency"),
                           ("chunk128", 128, "throughput")):
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, sh, C,
                                               "dense", "bf16")
        kw = dict(m=sh["m"], include_bg=True, mode=mode)
        ms = time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
            pre, k, v, q_pos, **kw), 200)
        plain_ms = time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
            pre, k, v, q_pos, **kw), 20)
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, sh["m"])
        out[label] = {"C": C, "mode": mode, "ms": ms, "plain_ms": plain_ms,
                      **bound(pre, k, q_pos, ks, grid, pairs),
                      **launch_info(torch, chunk_attn, pre, k, grid, mode,
                                    upper=False)}
    emit({"phase": "kernel_timing", "kernel": "chunk_attn", "arch": arch,
          "shape": sh, "cache": "bf16", "layout": "dense 4096-token slots",
          **out})
    return out


def launch_info(torch, chunk_attn, pre, k, grid, mode, upper):
    """The launch's split, grid, shared memory, blocks per SM (occupancy
    API) and the mean pages in a query tile's selection union."""
    geo = chunk_attn.launch_geometry(pre, k.dtype, mode=mode,
                                     sms=chunk_attn.sm_count(0))
    B, Hkv, G, C, D = pre.qg.shape
    return {"nsplit": geo["nsplit"], "grid": geo["grid"],
            "smem_bytes": geo["smem"], "workspace": geo["workspace"],
            "workspace_bytes": geo["ws_bytes"],
            "blocks_per_sm": chunk_attn.blocks_per_sm(
                k.dtype, D, pre.block_size, upper, geo["smem"],
                geo["workspace"]),
            "sms": chunk_attn.sm_count(0),
            "union_pages_per_tile": tile_union_pages(torch, grid,
                                                     geo["c_tile"])}


def _requests(Request, lengths, new_tokens, vocab):
    r = np.random.default_rng(SEED)
    return [Request(prompt=r.integers(0, vocab, n), max_new_tokens=new_tokens)
            for n in lengths]


def _dispatch_seconds(eng, hist):
    """Wall seconds summed over an engine's dispatches of one kind: the
    exact total of its telemetry histogram (each span ends after the device
    finished)."""
    return eng.telemetry.metrics.get(hist).total


def _top2_recorder(torch, engine_mod, Scheduler, vocab):
    """(patches, gaps): while the patches are on, every sampled token of a
    request (keyed by prompt length) records its logits' top-2 gap and top
    value as device scalars, in token order."""
    last, gaps = {}, {}
    orig_sample, orig_on_sampled = engine_mod.sample_batch, Scheduler.on_sampled

    def sample_batch(logits, *a, **kw):
        top2 = torch.topk(logits[:, :vocab].float(), 2, dim=-1).values
        last["gap"], last["top"] = top2[:, 0] - top2[:, 1], top2[:, 0]
        return orig_sample(logits, *a, **kw)

    def on_sampled(self, s, token):
        req = self.slots[s].req
        gaps.setdefault(len(req.prompt), []).append(
            (last["gap"][s], last["top"][s]))
        return orig_on_sampled(self, s, token)

    return (mock.patch.object(engine_mod, "sample_batch", sample_batch),
            mock.patch.object(Scheduler, "on_sampled", on_sampled)), gaps


def phase_engine_full_width(torch, chunk_attn, arch="qwen3-1.7b",
                            phase="engine_full_width",
                            new_tokens=SERVE["new_tokens"], layers=None):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request, Scheduler
    from repro_torch.serve import engine as engine_mod

    cfg = get_config(arch, **({} if layers is None else
                              {"num_layers": layers}))
    params = init_params(cfg, seed=SEED, device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(slots=4, max_len=4096, chunk=128),
                 device=DEVICE)
    reqs = _requests(Request, SERVE["prompts"], new_tokens, cfg.vocab)
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
    orig = (transformer.prefill_chunk, transformer.decode_step)

    def finite(fn):  # counts non-finite logits on the device, no sync
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return wrapped

    # top-2 logit gaps of every sampled token, for phase 14's near-tie rule
    (p_sample, p_sched), gaps = _top2_recorder(torch, engine_mod, Scheduler,
                                               cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(transformer, "prefill_chunk", finite(orig[0])), \
            mock.patch.object(transformer, "decode_step", finite(orig[1])), \
            p_sample, p_sched:
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
    base = {"streams": {len(r.prompt): np.asarray(r.out) for r in done},
            "gaps": {n: torch.stack([torch.stack(g) for g in v]).cpu().numpy()
                     for n, v in gaps.items()},
            "tok_per_s": st["generated_tokens"] / wall,
            "decode_tokens_per_dispatch": (st["generated_tokens"] - len(done))
            / st["decode_dispatches"]}
    emit({"phase": phase, "arch": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "activ_dtype": cfg.activ_dtype,
          "param_dtype": cfg.param_dtype, "slots": 4, "max_len": 4096,
          "chunk": 128, "prompts": list(SERVE["prompts"]),
          "new_tokens": new_tokens,
          "wall_s": wall, "generated_tokens": st["generated_tokens"],
          "tok_per_s": base["tok_per_s"],
          "prefill_tokens": st["prefill_tokens"],
          "prefill_dispatches": st["prefill_dispatches"],
          "prefill_s": _dispatch_seconds(eng, "prefill_chunk_seconds"),
          "decode_dispatches": st["decode_dispatches"],
          "decode_s": _dispatch_seconds(eng, "decode_step_seconds"),
          "decode_tokens_per_dispatch": base["decode_tokens_per_dispatch"],
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
    if any(len(o) != new_tokens or int(o.min()) < 0
           or int(o.max()) >= cfg.vocab for o in outs):
        raise AssertionError("a stream is short or holds an out-of-vocab token")
    if any(len(g) != new_tokens for g in base["gaps"].values()):
        raise AssertionError("a stream's top-2 gaps were not all recorded")
    return (launches, combines), eng, base


def _reset_chunk(chunk_attn):
    fn = chunk_attn.chunk_attention_kernel
    fn.launches = fn.upper_launches = fn.combine_launches = 0


def _splits(chunk_attn, cfg, slots, C, max_len):
    """Whether a dispatch of C-token chunks plans a split (and a combine)."""
    G = cfg.num_heads // cfg.kv_heads
    nb = max_len // cfg.attention.block_size
    tiles = -(-C // chunk_attn.tile_width("auto", C, G, cfg.hd))
    return chunk_attn.split_plan(slots, cfg.kv_heads, tiles, nb,
                                 chunk_attn.sm_count(0))[0] > 1


def _want_combines(chunk_attn, cfg, stats, slots, chunk, max_len):
    """Combine launches an engine run must make: one per layer of every
    dispatch whose planned split count is above 1 (decode: C = 1; prefill:
    C = chunk, the scheduler's fixed width)."""
    return sum(cfg.num_layers * stats[key]
               for C, key in ((1, "decode_dispatches"),
                              (chunk, "prefill_dispatches"))
               if _splits(chunk_attn, cfg, slots, C, max_len))


def _chunk_launches(chunk_attn):
    """(two-level launches, H-level launches) of the chunk kernel."""
    fn = chunk_attn.chunk_attention_kernel
    return fn.launches, fn.upper_launches


def _device_times(torch, prof, ranges=()):
    """From a finished torch.profiler's raw events: {name: µs} summed over
    the device events (kernels, copies) but the ``ranges``' own
    annotations, and {range: µs} of the device events that host operations
    inside the range's host events launched (on the range's thread), which
    is how ``key_averages()`` attributes them (``_key_average_times``).
    ``key_averages()`` builds a Python object and a tree over every event
    first, tens of seconds for a training step's; this is one pass."""
    import bisect

    from torch.autograd import DeviceType

    device = DeviceType.CUDA
    names, kernel_ns = {}, {}
    ops, intervals, launched = {}, {r: {} for r in ranges}, []
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == device:
            raw, ns = e.name(), e.duration_ns()
            name = names.get(raw)
            if name is None:
                name = names[raw] = torch._C._demangle(raw) if len(raw) > 1 \
                    else raw
            if name not in ranges:
                kernel_ns[name] = kernel_ns.get(name, 0) + ns
            if ranges:
                launched.append((e.linked_correlation_id(), ns))
        elif (ranges and e.linked_correlation_id() == 0 and not e.is_async()
              and e.start_thread_id() == e.end_thread_id()):
            # a host operation: the device events link to it by its id
            tid, t0, t1 = e.start_thread_id(), e.start_ns(), e.end_ns()
            ops[e.correlation_id()] = (tid, t0, t1)
            if e.name() in intervals:
                intervals[e.name()].setdefault(tid, []).append((t0, t1))
    span_ns = dict.fromkeys(ranges, 0)
    for r, by_thread in intervals.items():
        for iv in by_thread.values():
            iv.sort()
        starts = {tid: [a for a, _ in iv] for tid, iv in by_thread.items()}
        for corr, ns in launched:
            op = ops.get(corr)
            if op is None or op[0] not in by_thread:
                continue
            tid, t0, t1 = op
            i = bisect.bisect_right(starts[tid], t0) - 1
            if i >= 0 and t1 <= by_thread[tid][i][1]:
                span_ns[r] += ns
    return ({k: ns / 1e3 for k, ns in kernel_ns.items()},
            {r: ns / 1e3 for r, ns in span_ns.items()})


def _key_average_times(prof, ranges=()):
    """``_device_times`` through ``key_averages()``: what it replaced, kept
    to hold it (phase 49's profile)."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernel_us = {}
    for e in events:
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and e.key not in ranges:
            kernel_us[e.key] = kernel_us.get(e.key, 0.0) + us
    span_us = {name: sum(
        getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        for e in events
        if e.key == name and e.device_type == DeviceType.CPU)
        for name in ranges}
    return kernel_us, span_us


def _profile(torch, fn, steps, kernels=("chunk_attn",), ranges=(),
             warm=False, alone=True, check=False):
    """Wall ms per call without the profiler, then torch.profiler over the
    same calls: device ms per call, busy share, the named kernels' ms, the
    device ms of the kernels launched inside each named
    ``record_function`` range, and the top kernels. One call warms up
    first unless ``warm`` (the caller just ran the same work). Without
    ``alone`` the calls run once, under the profiler, and its wall time
    stands for theirs (for calls of seconds, where the profiler's own cost
    is small). ``check`` also sums the events through ``key_averages()``
    and fails unless both sums agree."""
    from torch.profiler import ProfilerActivity, profile

    if not warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps if alone else 0):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    # host activity only where a range is asked for: the host's operator
    # events outnumber the kernels and most of the profiler's time goes to
    # processing them
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    if not alone:
        wall_ms = prof_wall_ms
    # device events only: an operator's row would repeat its kernels' time,
    # and a range's device-side annotation spans its kernels and the gaps
    t0 = time.perf_counter()
    kernel_us, span_us = _device_times(torch, prof, ranges)
    held = {"events_s": time.perf_counter() - t0}
    if check:
        t0 = time.perf_counter()
        ka_kernel, ka_span = _key_average_times(prof, ranges)
        held["key_averages_s"] = time.perf_counter() - t0
        ka_kernel = {k: us for k, us in ka_kernel.items() if us > 0}
        got = {k: us for k, us in kernel_us.items() if us > 0}
        rel = [abs(got[k] - ka_kernel[k]) / ka_kernel[k]
               for k in set(got) & set(ka_kernel)]
        rel += [abs(span_us[r] - ka_span[r]) / max(ka_span[r], 1e-9)
                for r in ranges]
        held.update(kernels=len(got), ranges=dict(span_us),
                    max_rel_diff=max(rel, default=0.0))
        if set(got) != set(ka_kernel) or held["max_rel_diff"] > 1e-6:
            raise AssertionError(
                f"profiler sums differ from key_averages(): {held}; only in "
                f"events: {sorted(set(got) - set(ka_kernel))[:5]}, only in "
                f"key_averages: {sorted(set(ka_kernel) - set(got))[:5]}")
    rows = sorted(((k, us / 1e3 / steps) for k, us in kernel_us.items()
                   if us > 0), key=lambda r: -r[1])
    device_ms = sum(ms for _, ms in rows)
    spans = {f"{name}_ms": span_us[name] / 1e3 / steps for name in ranges}
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms,
            "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            **{f"{name}_ms": sum(ms for k, ms in rows if name in k)
               for name in kernels}, **spans,
            "top": [[k[:100], ms] for k, ms in rows[:10]],
            "sums": held}


def phase_profile(torch, eng, C=128, phase="profile", kernels=("chunk_attn",),
                  check=False):
    """Where a full-width dispatch's time goes, on the engine's own cache
    after its run: decode waves of every slot, and C-token prefill chunks.
    For an MoE model the routed FFN of every layer runs inside a
    ``moe_block`` range, whose kernels' device time is reported apart.
    ``check``: ``_profile``'s."""
    from repro_torch.models import transformer
    from repro_torch.serve.sampling import greedy_batch

    ranges = ("moe_block",) if eng.cfg.family == "moe" else ()
    orig_moe = transformer.moe_block

    def moe_block(*a, **kw):
        with torch.profiler.record_function("moe_block"):
            return orig_moe(*a, **kw)

    B = eng.slots
    toks = torch.arange(1, B + 1, device=DEVICE)
    active = torch.ones(B, dtype=torch.bool, device=DEVICE)
    chunk = (torch.arange(1, B * C + 1, device=DEVICE)
             % eng.cfg.vocab).reshape(B, C)
    nv = torch.full((B,), C, dtype=torch.int32, device=DEVICE)

    def decode():
        logits, _ = eng.model.decode_step(eng.params, eng.cfg, eng.kv.tree,
                                          toks, active=active)
        greedy_batch(logits, vocab=eng.cfg.vocab).cpu()

    def prefill():
        eng.model.prefill_chunk(eng.params, eng.cfg, eng.kv.tree, chunk, nv)

    with mock.patch.object(transformer, "moe_block", moe_block):
        emit({"phase": phase, "note": "ms per dispatch; device_ms = summed "
              "kernel time from torch.profiler; busy_share = device_ms / "
              "wall_ms", "arch": eng.cfg.name, "slots": B,
              "decode_step": _profile(torch, decode, PROFILE_STEPS["decode"],
                                      kernels=kernels, ranges=ranges,
                                      check=check),
              f"prefill_chunk_{C}": _profile(
                  torch, prefill, PROFILE_STEPS["prefill"], kernels=kernels,
                  ranges=ranges, check=check)})


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
# the chunk kernel at head dim 80 and past its shared-memory page arrays
# --------------------------------------------------------------------------- #
def _same_bits(torch, a, b):
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _nsplit_sweep(torch, chunk_attn, pre, k, v, q_pos, kw, iters,
                  mode="latency"):
    """ms of the two-level program at the planned nsplit and at half, twice
    and four times it (within [1, nb]), keyed by nsplit; "plan" names the
    planned count."""
    nb = pre.pb.shape[1]
    planned = chunk_attn.launch_geometry(pre, k.dtype, mode=mode,
                                         sms=chunk_attn.sm_count(0))["nsplit"]
    out = {"plan": planned}
    for ns in (planned // 2, planned, 2 * planned, 4 * planned):
        if 1 <= ns <= nb:
            out[str(ns)] = time_ms(torch, lambda: chunk_attn._launch(
                pre, k, v, q_pos, nsplit=ns, mode=mode, **kw), iters)
    return out


def _program_times(torch, chunk_attn, pre, k, v, q_pos, kw, iters):
    """Median ms of the shared-memory and the workspace program, forced,
    over two interleaved runs each."""
    runs = {"shared": [], "workspace": []}
    for prog in ("shared", "workspace", "workspace", "shared"):
        runs[prog].append(time_ms(torch, lambda: chunk_attn._launch(
            pre, k, v, q_pos, workspace=prog == "workspace", **kw), iters))
    return {f"{prog}_ms": float(np.median(t)) for prog, t in runs.items()}


def phase_chunk_d80(torch, tmd, chunk_attn):
    """Phase 40: the chunk kernel at hubert-xlarge's (80, 128), G = 1, both
    programs, bf16 / fp32 / int8 caches, decode and C = 128 / 5, held to the
    plain twin at the serving tolerance; two blocks an SM for each program;
    the workspace program forced at (80, 128) and at the main shape equals
    the shared-memory one bit for bit, and both are timed; the main
    decode's planned split is timed beside half, twice and four times it;
    then the hubert engine at full width
    (HUBERT_SERVE_LAYERS of 48 layers, bf16) and its fp32 2-layer greedy
    streams against the plain route's."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serve import EngineConfig, Request

    sh = HUBERT_SERVE
    worst, ties, rows, n, upper_cases = 0.0, 0, 0, 0, 0
    for (C, mode), layout, dtype, variant, nu in itertools.product(
            ((1, "latency"), (128, "throughput"), (5, "throughput")),
            ("dense", "ring", "ragged"), ("bf16", "fp32", "int8"),
            ("full", "sparse"), (0, 33)):
        if nu and (variant == "sparse" or layout == "ragged"):
            continue
        n += 1
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + 4000 + n,
                                               sh, C, layout, dtype)
        if nu:
            pre = pre._replace(upper=upper_view(
                torch, SEED + 5000 + n, sh["B"], sh["Hkv"], sh["D"], nu,
                "some_dead"))
            upper_cases += 1
        kw = dict(m=sh["m"], k_scale=ks, v_scale=vs,
                  include_bg=variant == "full", mode=mode)
        got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
        ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
        torch.cuda.synchronize()
        err, t, r = _hold(torch, tmd, got, pre, q_pos, sh["m"], ref,
                          f"d80 C={C} {layout} {dtype} {variant} NU={nu}")
        worst, ties, rows = max(worst, err), ties + t, rows + r
    occupancy = {}
    for dt, upper in itertools.product(
            (torch.bfloat16, torch.float32, torch.int8), (False, True)):
        for C in (1, 128):
            geo = chunk_attn.plan(sh["B"], sh["Hkv"], sh["G"], C, sh["D"],
                                  sh["b"], sh["nb"], dt,
                                  sms=chunk_attn.sm_count(0))
            bps = chunk_attn.blocks_per_sm(dt, sh["D"], sh["b"], upper,
                                           geo["smem"])
            occupancy[f"{str(dt)[6:]} C={C} "
                      f"{'upper' if upper else 'two_level'}"] = bps
    low = {k: v for k, v in occupancy.items() if v < 2}
    # the workspace program against the shared-memory one, forced: the same
    # bits, and their times (interleaved, the median of two runs each)
    same, ws_time = {}, {}
    for name, shp in (("d80", sh), ("main", MAIN)):
        for C, mode in ((1, "latency"), (128, "throughput")):
            pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + 6000,
                                                   shp, C, "ring", "bf16")
            kw = dict(m=shp["m"], include_bg=True, mode=mode)
            a = chunk_attn._launch(pre, k, v, q_pos, workspace=False, **kw)
            b = chunk_attn._launch(pre, k, v, q_pos, workspace=True, **kw)
            same[f"{name} C={C}"] = _same_bits(torch, a, b)
            ws_time[f"{name} C={C}"] = _program_times(
                torch, chunk_attn, pre, k, v, q_pos, kw, 100)
    timing = {}
    for label, C, mode, nu in (("decode", 1, "latency", 0),
                               ("chunk128", 128, "throughput", 0),
                               ("upper_decode", 1, "latency", 33),
                               ("upper_chunk128", 128, "throughput", 33)):
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, sh, C,
                                               "dense", "bf16")
        if nu:  # the H-level program over NU collapsed entries
            pre = pre._replace(upper=upper_view(
                torch, SEED + 1, sh["B"], sh["Hkv"], sh["D"], nu, "all_live"))
        kw = dict(m=sh["m"], include_bg=True, mode=mode)
        ms = time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
            pre, k, v, q_pos, **kw), 200)
        plain_ms = time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
            pre, k, v, q_pos, **kw), 20)
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, sh["m"])
        timing[label] = {"ms": ms, "plain_ms": plain_ms,
                         **bound(pre, k, q_pos, ks, grid, pairs, nu=nu),
                         **launch_info(torch, chunk_attn, pre, k, grid, mode,
                                       upper=bool(nu))}
    pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, MAIN, 1,
                                           "dense", "bf16")
    main_split = _nsplit_sweep(torch, chunk_attn, pre, k, v, q_pos,
                               dict(m=MAIN["m"], include_bg=True), 100)
    emit({"phase": "chunk_d80", "shape": sh, "cases": n,
          "upper_cases": upper_cases, "atol": ATOL, "rtol": RTOL,
          "max_abs_err": worst, "near_tie_rows": ties, "rows": rows,
          "blocks_per_sm": occupancy, "workspace_bitwise": same,
          "workspace_vs_shared": ws_time, "main_decode_ms_by_nsplit":
          main_split, **timing})
    if ties > 0.01 * rows:
        raise AssertionError(f"{ties} near-tie rows of {rows} exceed 1%")
    if low:
        raise AssertionError(f"D = 80 programs under two blocks an SM: {low}")
    if not all(same.values()):
        raise AssertionError(f"workspace program != shared-memory one: {same}")
    # the hubert engine at full width, then its 2-layer fp32 streams
    launches, eng, _ = phase_engine_full_width(
        torch, chunk_attn, arch=HUBERT_ARCH, phase="hubert_engine",
        new_tokens=HUBERT_SERVE_TOKENS, layers=HUBERT_SERVE_LAYERS)
    del eng
    torch.cuda.empty_cache()
    small = get_config(HUBERT_ARCH, num_layers=2, activ_dtype="float32")
    params = init_params(small, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=4, max_len=4096, chunk=128)
    reqs = _requests(Request, SERVE["prompts"], 16, small.vocab)
    streams = [_streams(torch, chunk_attn, small, params, ecfg, reqs, plain)
               for plain in (False, True)]
    equal = all(np.array_equal(streams[0][k], streams[1][k])
                for k in streams[0])
    emit({"phase": "hubert_engine_parity", "layers": 2,
          "activ_dtype": "float32", "prompts": list(SERVE["prompts"]),
          "new_tokens": 16, "identical_streams": equal})
    if not equal:
        raise AssertionError("hubert fp32 2-layer streams differ kernel vs "
                             "plain")
    return worst, timing, launches


def phase_chunk_long_pages(torch, tmd, chunk_attn):
    """Phase 41: the chunk kernel at 4096 pages (524,288-token slots):
    LONG_PAGES' calls held to the plain twin at the serving tolerance over
    dense and ring layouts (bf16, and int8 for the decodes), then timed
    beside the bound and the plain twin in their cache type (the planned
    split also beside half, twice and four times it); each plans
    the program LONG_PAGES expects (the workspace one where the page arrays
    do not fit shared memory)."""
    out, worst = {}, 0.0
    for label, arch, sh, C, mode, tdt, want_ws in LONG_PAGES:
        err_arch, ties, rows = 0.0, 0, 0
        dtypes = ("bf16", "int8") if C == 1 else ("bf16",)
        for i, (layout, dtype) in enumerate(itertools.product(
                ("dense", "ring"), dtypes)):
            pre, k, v, q_pos, ks, vs = kernel_case(
                torch, tmd, SEED + 7000 + i, sh, C, layout, dtype)
            kw = dict(m=sh["m"], k_scale=ks, v_scale=vs, include_bg=True,
                      mode=mode)
            got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            torch.cuda.synchronize()
            err, t, r = _hold(torch, tmd, got, pre, q_pos, sh["m"], ref,
                              f"{label} nb={sh['nb']} {layout} {dtype}")
            err_arch, ties, rows = max(err_arch, err), ties + t, rows + r
            del pre, k, v, got, ref
            torch.cuda.empty_cache()
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, sh, C,
                                               "dense", tdt)
        kw = dict(m=sh["m"], k_scale=ks, v_scale=vs, include_bg=True,
                  mode=mode)
        before = chunk_attn.chunk_attention_kernel.launches
        ms = time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
            pre, k, v, q_pos, **kw), 20)
        plain_ms = time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
            pre, k, v, q_pos, **kw), 3)
        launches = chunk_attn.chunk_attention_kernel.launches - before
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, sh["m"])
        info = launch_info(torch, chunk_attn, pre, k, grid, mode,
                           upper=False)
        info["ms_by_nsplit"] = _nsplit_sweep(  # the plan and its neighbours
            torch, chunk_attn, pre, k, v, q_pos,
            dict(m=sh["m"], k_scale=ks, v_scale=vs, include_bg=True), 10,
            mode)
        out[label] = {"arch": arch, "shape": sh, "C": C, "mode": mode,
                      "cache": tdt, "max_abs_err": err_arch,
                      "near_tie_rows": ties,
                     "rows": rows, "ms": ms, "plain_ms": plain_ms,
                     "timed_launches": launches,
                     **bound(pre, k, q_pos, ks, grid, pairs), **info}
        worst = max(worst, err_arch)
        del pre, k, v
        torch.cuda.empty_cache()
        if info["workspace"] != want_ws:
            raise AssertionError(f"{label}: nb = {sh['nb']} planned the "
                                 f"workspace program: {info['workspace']}")
        if ties > 0.01 * rows:
            raise AssertionError(f"{label}: {ties} near-tie rows of {rows}")
    emit({"phase": "chunk_long_pages", "atol": ATOL, "rtol": RTOL,
          "max_abs_err": worst, **out})
    return worst, out


# --------------------------------------------------------------------------- #
# the reference's shape cells at qwen3-1.7b's full width (phases 42-44)
# --------------------------------------------------------------------------- #
def phase_train_lm(torch, bsa):
    """Phase 45: ``repro_torch.examples.train_lm`` at its small preset
    (head dim 32, block 32) for TRAIN_LM_STEPS steps of MRA-2 on the card,
    its three kernels at that call held against their plain twins first;
    losses finite, each kernel launched once a layer a step."""
    from repro_torch.examples import train_lm

    errs = {}
    for i, dt in enumerate((torch.bfloat16, torch.float32)):
        e, _ = _bsa_hold(torch, bsa, TRAIN_LM_BSA, 2, dt, SEED + 9000 + i,
                         i == 1)
        for key, v in e.items():
            errs[key] = max(errs.get(key, 0.0), v)
    timing = _bsa_timing(torch, bsa, TRAIN_LM_BSA, 2, True)
    _reset_bsa(bsa)
    t0 = time.perf_counter()
    losses = train_lm.run("small", TRAIN_LM_STEPS, "mra2", "1", None,
                          DEVICE)["mra2"]
    wall = time.perf_counter() - t0
    launches = _bsa_launches(bsa)
    layers = train_lm.PRESETS["small"]["num_layers"]
    emit({"phase": "train_lm", "preset": "small", "steps": TRAIN_LM_STEPS,
          "losses": losses, "wall_s": wall, "launches": launches,
          "bsa_d32_b32": {"max_abs_err": errs, **timing}})
    want = layers * TRAIN_LM_STEPS
    if (len(losses) != TRAIN_LM_STEPS or not np.isfinite(losses).all()
            or any(v != want for v in launches.values())):
        raise AssertionError(f"train_lm: losses {losses}, launches "
                             f"{launches} (want {want} each)")
    return launches, errs, timing


def _cell_rows(cache, lo, hi):
    """Slots [lo, hi) of a serving cache: views, written in place."""
    return {k: [t[lo:hi] for t in v] if isinstance(v, list) else v[lo:hi]
            for k, v in cache.items()}


def _cell_predict(cell, kind, cut):
    """The dry run's one-rank prediction of a step of ``kind`` under
    ``cut``: peak GiB, FLOPs, the roofline's terms and its time (the
    larger term, as the terms overlap), the kernels' launch keys."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import AbstractMesh

    kw = {k: v for k, v in cut.items() if k in ("batch", "layers")}
    if cut.get("kv_quant"):
        kw["attention_override"] = {"kv_quant": True}
    if cut.get("param_dtype"):
        kw["config_override"] = {"param_dtype": cut["param_dtype"]}
    res = dryrun.lower_cell(SHAPE_ARCH, cell, mesh=AbstractMesh(1, 1),
                            kind=kind, **kw)
    res["status"] = "ok"
    row = roofline.analyze(res)
    return {"peak_gib": res["memory"]["peak_bytes"] / 2**30,
            "argument_gib": res["memory"]["arguments"] / 2**30,
            "flops": res["cost"]["flops_per_device"],
            "kernel_flops": res["cost"]["kernel_flops_per_device"],
            "model_flops": res["model_flops_total"],
            "compute_ms": 1e3 * row["compute_s"],
            "memory_ms": 1e3 * row["memory_s"],
            "roofline_ms": 1e3 * max(row["compute_s"], row["memory_s"]),
            "kernels": {k: v["calls"] for k, v in res["kernels"].items()},
            "kernels_unbuilt": res["kernels_unbuilt"], "dry_run_s": res["lower_s"]}


def _cell_cut(cell, kinds, candidates):
    """The first cut of ``candidates`` whose predicted peak for the step of
    ``kinds[0]`` (the one that peaks) stays under CELL_GIB, and the other
    steps' predictions under it: (cut, {kind: prediction}, tried)."""
    tried = []
    for cut in candidates:
        pred = {kinds[0]: _cell_predict(cell, kinds[0], cut)}
        peak = pred[kinds[0]]["peak_gib"]
        tried.append({"cut": cut, "predicted_peak_gib": peak})
        if peak < CELL_GIB:
            pred.update({k: _cell_predict(cell, k, cut) for k in kinds[1:]})
            return cut, pred, tried
    raise AssertionError(f"{cell}: no cut fits {CELL_GIB} GiB: {tried}")


def _cell_model(torch, cut):
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params, map_specs, materialize
    from repro_torch.models.transformer import cache_specs

    over = {}
    if cut.get("param_dtype"):
        over["param_dtype"] = cut["param_dtype"]
    if cut.get("layers"):
        over["num_layers"] = cut["layers"]
    cfg = get_config(SHAPE_ARCH, **over)
    if cut.get("kv_quant"):
        cfg = cfg.replace(attention=dataclasses.replace(cfg.attention,
                                                        kv_quant=True))
    params = init_params(cfg, seed=SEED, device=DEVICE)
    return cfg, params, lambda B, S: map_specs(
        cache_specs(cfg, B, S), lambda s: materialize(s, DEVICE))


def _cell_tokens(torch, cfg, B, S, seed):
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=g, device=DEVICE,
                         dtype=torch.int32)


def _cell_step(torch, fn, kernels, then):
    """One call of ``fn`` under the profiler (its device time, the named
    kernels' ms, the top kernels), then ``then(fn's result)``, the same
    work, once without it: its wall, and the busy share as the profiled
    call's device time over that wall (the profiler's own host cost stays
    out of it). Returns (the second call's result, the timings)."""
    res = {}

    def call():
        res["out"] = fn()

    prof = _profile(torch, call, 1, kernels=kernels, warm=True, alone=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = then(res["out"])
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    return out, {"wall_ms": wall_ms, "profiled_wall_ms": prof["wall_ms"],
                 "device_ms": prof["device_ms"],
                 "busy_share": prof["device_ms"] / wall_ms,
                 **{f"{k}_ms": prof[f"{k}_ms"] for k in kernels},
                 "top": prof["top"][:4]}


def _bsa_fwd_hold(torch, bsa, sh, G, seed, heads=None):
    """``bsa_fwd`` on one MRA-2 selection at ``sh`` against its plain twin
    (numerator / row sums at BSA_TOL, mt at MT_TOL): (errors, call ms, plain
    ms). ``heads`` holds only those BHG rows against the twin (the kernel
    runs on every row; the twin's gathered blocks of all would not fit)."""
    q, k, v, c, x, y, fl, km, scale = bsa_case(torch, sh, G, torch.bfloat16,
                                               seed, False, device_draws=True)
    b, nb = sh["b"], sh["n"] // sh["b"]
    kw = dict(scale=scale, block_size=b)
    pq = bsa.group_by_query(x, y, fl, nb)
    out, rs, mt = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)
    ms = time_ms(torch, lambda: bsa.bsa_fwd(q, k, v, c, pq, km, **kw), 3)
    rows = slice(None) if heads is None else heads
    kv = rows if heads is None else slice(heads.start // G, heads.stop // G)
    args = (q[rows], k[kv], v[kv], x[rows], y[rows], fl[rows], c[rows],
            km[kv])
    ref = bsa.block_sparse_attention_ref(*args, **kw)
    plain_ms = time_ms(torch, lambda: bsa.block_sparse_attention_ref(
        *args, **kw), 1)
    out, rs, mt = out[rows], rs[rows], mt[rows]
    alive = rs > 0

    def norm(o, r):
        return torch.where(alive[..., None], o, 0.0) / torch.where(
            alive, r, 1.0)[..., None]

    errs = {"bsa_fwd": float((norm(out, rs) - norm(ref[0], ref[1])).abs().max()),
            "mt": float((mt - ref[2]).abs().max())}
    ok = (bool(torch.isclose(norm(out, rs), norm(ref[0], ref[1]), rtol=BSA_TOL,
                             atol=BSA_TOL).all())
          and bool(torch.isclose(rs, ref[1], rtol=BSA_TOL, atol=BSA_TOL).all())
          and errs["mt"] <= MT_TOL and bool(torch.isfinite(out).all())
          and torch.equal(alive, ref[1] > 0))
    if not ok:
        raise AssertionError(f"bsa_fwd != plain at n={sh['n']}: {errs}")
    full = int(((fl & 1) == 1).sum())
    diag = int((((fl & 1) == 1) & ((fl & 2) == 2)).sum())
    return errs, ms, plain_ms, _bsa_bounds(q, k, fl, nb, "bsa_fwd")


def _cell_emit(name, cut, tried, pred, measured, extra):
    peak = measured["peak_gib"]
    want = max(p["peak_gib"] for p in pred.values())
    emit({"phase": name, "arch": SHAPE_ARCH, "cut": cut, "cuts_tried": tried,
          "predicted": pred, "measured": measured,
          "peak_vs_predicted": peak / want, **extra})
    if abs(peak / want - 1) > CELL_PEAK_TOL:
        raise AssertionError(f"{name}: card peak {peak:.2f} GiB vs predicted "
                             f"{want:.2f} GiB")


def phase_cell_prefill(torch, bsa):
    """Phase 42: ``prefill_32k`` at qwen3-1.7b's full width through
    ``transformer.prefill``: the batch the dry run fits on the card, the
    prediction beside the card's peak, wall, device time and busy share;
    ``bsa_fwd`` at n = 32768 held against its plain twin (one slot)."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import transformer

    S = SHAPES["prefill_32k"].seq_len
    sh = dict(B=1, Hq=16, n=S, d=128, b=128, bpr=4)
    errs, ms, plain_ms, bnd = _bsa_fwd_hold(torch, bsa, sh, 2, SEED)
    torch.cuda.empty_cache()
    cut, pred, tried = _cell_cut("prefill_32k", ("prefill",),
                                 CELL_CUTS["prefill_32k"])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, make_cache = _cell_model(torch, cut)
    B = cut["batch"]
    cache = make_cache(B, S)
    toks = _cell_tokens(torch, cfg, B, S, SEED)
    _reset_bsa(bsa)

    def run(_=None):
        return transformer.prefill(params, cfg, {"tokens": toks}, cache)

    (logits, _), step = _cell_step(torch, run, ("bsa_fwd",), run)
    launches = _bsa_launches(bsa)["bsa_fwd"]
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    ok = bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
        B, cfg.padded_vocab)
    del params, cache, logits, toks
    torch.cuda.empty_cache()
    _cell_emit("cell_prefill_32k", cut, tried, pred,
               {"peak_gib": peak, **step, "bsa_fwd_launches": launches,
                "finite_logits": ok},
               {"bsa_fwd_n32768": {"max_abs_err": errs, "ms": ms,
                                   "plain_ms": plain_ms, **bnd}})
    if not ok or launches != 2 * cfg.num_layers:  # profiled, then timed
        raise AssertionError(f"prefill_32k: finite {ok}, {launches} bsa_fwd "
                             "launches")
    return {"launches": launches, "max_abs_err": errs["bsa_fwd"], "ms": ms,
            "plain_ms": plain_ms, **bnd}


def _cell_decode(torch, chunk_attn, cfg, params, cache, logits, steps):
    """``steps`` + 1 greedy decode steps of every slot, the first profiled
    and the second timed alone (``_cell_step``): (the tokens of the last
    steps - 1, (steps - 1, B); the timing, two-level launches, combines)."""
    from repro_torch.models import transformer

    def step_after(res):
        tok = res[0].argmax(-1).to(torch.int32)
        return transformer.decode_step(params, cfg, cache, tok)

    _reset_chunk(chunk_attn)
    (logits, _), step = _cell_step(
        torch, lambda: step_after((logits,)), ("chunk_attn",), step_after)
    out = []
    for _ in range(steps - 1):
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        logits, _ = transformer.decode_step(params, cfg, cache, tok)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode: non-finite logits")
    fn = chunk_attn.chunk_attention_kernel
    return torch.stack(out), step, fn.launches, fn.combine_launches


def phase_cell_decode(torch, chunk_attn):
    """Phase 43: ``decode_32k``: the slots the dry run fits, filled by
    ``transformer.prefill`` a few at a time (each group's cache rows are
    views of the whole cache), then greedy ``decode_step``s of every slot
    over 256 pages each; the chunk kernel at that shape held against its
    plain twin, its planned split timed beside half, twice and four times
    it, and the workspace program forced beside the shared one."""
    from repro_torch.configs import SHAPES
    from repro_torch.core import mra_decode as tmd
    from repro_torch.models import transformer

    S = SHAPES["decode_32k"].seq_len
    cut, pred, tried = _cell_cut("decode_32k", ("decode",),
                                 CELL_CUTS["decode_32k"])
    fill = cut["fill"]
    fill_pred = _cell_predict("decode_32k", "prefill", dict(cut, batch=fill))
    pred["prefill_fill"] = dict(fill_pred, peak_gib=pred["decode"]["argument_gib"]
                                + fill_pred["peak_gib"]
                                - fill_pred["argument_gib"])
    sh = dict(B=cut["batch"], Hkv=8, G=2, D=128, b=128, nb=S // 128, m=16)
    worst = 0.0
    for i, dt in enumerate(("bf16", "int8")):
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + 8000 + i,
                                               sh, 1, "ring", dt)
        kw = dict(m=sh["m"], k_scale=ks, v_scale=vs, include_bg=True)
        got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
        ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _hold(torch, tmd, got, pre, q_pos, sh["m"], ref,
                                 f"decode_32k {dt}")[0])
    pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, sh, 1, "dense",
                                           "bf16")
    kw = dict(m=sh["m"], include_bg=True)
    ms = time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
        pre, k, v, q_pos, **kw), 20)
    plain_ms = time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
        pre, k, v, q_pos, **kw), 3)
    _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, sh["m"])
    kern = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            **bound(pre, k, q_pos, ks, grid, pairs),
            **launch_info(torch, chunk_attn, pre, k, grid, "latency", False),
            "ms_by_nsplit": _nsplit_sweep(torch, chunk_attn, pre, k, v,
                                          q_pos, kw, 20),
            "workspace_vs_shared": _program_times(
                torch, chunk_attn, pre, k, v, q_pos, kw, 20)}
    del pre, k, v, got, ref
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, make_cache = _cell_model(torch, cut)
    B = cut["batch"]
    cache = make_cache(B, S)
    t0 = time.perf_counter()
    last = []
    for lo in range(0, B, fill):
        toks = _cell_tokens(torch, cfg, fill, S, SEED + lo)
        lg, _ = transformer.prefill(params, cfg, {"tokens": toks},
                                    _cell_rows(cache, lo, lo + fill))
        last.append(lg)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    toks, step, launches, combines = _cell_decode(
        torch, chunk_attn, cfg, params, cache, torch.cat(last), CELL_STEPS)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del params, cache
    torch.cuda.empty_cache()
    want = cfg.num_layers * (CELL_STEPS + 1)  # the profiled step, the rest
    _cell_emit("cell_decode_32k", cut, tried, pred,
               {"peak_gib": peak, "fill_s": fill_s, "decode_step": step,
                "decode_steps": CELL_STEPS, "chunk_attn_launches": launches,
                "combine_launches": combines,
                "tokens_in_vocab": bool((toks >= 0).all()
                                        and (toks < cfg.vocab).all())},
               {"chunk_attn_nb256": kern})
    if launches != want:
        raise AssertionError(f"decode_32k: {launches} chunk_attn launches != "
                             f"{want}")
    return {"launches": launches, "combines": combines, **kern}


def phase_cell_long(torch, bsa, chunk_attn):
    """Phase 44: ``long_500k`` at batch 1: ``transformer.prefill`` of
    524,288 tokens (``bsa_fwd`` at n = 524288), then greedy decode steps
    over 4096 pages (the chunk kernel at G = 2, int8), under the cut
    the dry run chooses; ``bsa_fwd`` at that n held against its plain twin
    on the last KV head's two query heads."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import transformer

    S = SHAPES["long_500k"].seq_len
    sh = dict(B=1, Hq=16, n=S, d=128, b=128, bpr=4)
    errs, ms, plain_ms, bnd = _bsa_fwd_hold(torch, bsa, sh, 2, SEED,
                                            heads=slice(14, 16))
    torch.cuda.empty_cache()
    cut, pred, tried = _cell_cut("long_500k", ("prefill", "decode"),
                                 CELL_CUTS["long_500k"])
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg, params, make_cache = _cell_model(torch, cut)
    cache = make_cache(1, S)
    toks = _cell_tokens(torch, cfg, 1, S, SEED)
    _reset_bsa(bsa)

    def run(_=None):
        return transformer.prefill(params, cfg, {"tokens": toks}, cache)

    (logits, _), step = _cell_step(torch, run, ("bsa_fwd",), run)
    launches = _bsa_launches(bsa)["bsa_fwd"]
    del toks
    out, dstep, chunk_launches, combines = _cell_decode(
        torch, chunk_attn, cfg, params, cache, logits, CELL_STEPS)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del params, cache, logits
    torch.cuda.empty_cache()
    _cell_emit("cell_long_500k", cut, tried, pred,
               {"peak_gib": peak, "prefill": step, "decode_step": dstep,
                "bsa_fwd_launches": launches, "decode_steps": CELL_STEPS,
                "chunk_attn_launches": chunk_launches,
                "combine_launches": combines,
                "context_tok_per_s": S / (step["wall_ms"] / 1e3)},
               {"bsa_fwd_n524288": {"max_abs_err": errs, "ms": ms,
                                    "plain_ms": plain_ms, "held_rows": [14, 16],
                                    **bnd}})
    if launches != 2 * cfg.num_layers:  # profiled, then timed
        raise AssertionError(f"long_500k: {launches} bsa_fwd launches")
    if chunk_launches != cfg.num_layers * (CELL_STEPS + 1):
        raise AssertionError(f"long_500k: {chunk_launches} chunk launches")
    return {"bsa_launches": launches, "chunk_launches": chunk_launches,
            "combines": combines, "max_abs_err": errs["bsa_fwd"], "ms": ms,
            "plain_ms": plain_ms, **bnd}


# --------------------------------------------------------------------------- #
# the MoE family: granite-moe-3b-a800m served at full width, its parity and
# the whole-prompt prefill
# --------------------------------------------------------------------------- #
def phase_moe_drops(torch, eng):
    """The experts' dropped-assignment share in the prefill dispatches of
    phase-4 traffic, counted outside the timed run: the same engine config
    and prompts again with one new token each (the same prefill dispatches,
    no decode wave), the kept and total assignments of every layer's
    ``_dispatch`` summed on the device."""
    from repro_torch.models import moe
    from repro_torch.serve import Engine, Request

    kept = torch.zeros((), dtype=torch.int64, device=DEVICE)
    total = torch.zeros((), dtype=torch.int64, device=DEVICE)
    calls = [0]
    orig = moe._dispatch

    def counted(x, idx, **kw):
        buf, meta = orig(x, idx, **kw)
        kept.add_(meta[3].sum())
        total.add_(meta[3].numel())
        calls[0] += 1
        return buf, meta

    run = Engine(eng.cfg, eng.params, eng.config, device=DEVICE)
    reqs = _requests(Request, SERVE["prompts"], 1, eng.cfg.vocab)
    with mock.patch.object(moe, "_dispatch", counted):
        run.run(reqs)
    st = run.stats
    if st["decode_dispatches"] or calls[0] != (eng.cfg.num_layers
                                               * st["prefill_dispatches"]):
        raise AssertionError(f"drop count: {calls[0]} dispatch calls over "
                             f"{st['prefill_dispatches']} prefill and "
                             f"{st['decode_dispatches']} decode dispatches")
    spec = eng.cfg.moe
    T = eng.slots * eng.chunk
    out = {"prefill_dispatches": st["prefill_dispatches"],
           "assignments": int(total), "dropped": int(total - kept),
           "dropped_share": float(total - kept) / float(total),
           "capacity_per_expert": moe.capacity(T, spec),
           "tokens_per_dispatch": T}
    emit({"phase": "moe_drops", "arch": eng.cfg.name, **out})
    del run
    return out


def phase_moe_parity(torch, chunk_attn, bsa):
    """granite-moe: greedy streams kernel vs plain at the smoke size, first
    tokens at full width (4 layers, fp32), and the whole-prompt prefill of
    one 4096-token prompt against prefill_chunk over the same prompt.

    The prefill comparison: K/V and pyramid of layer 0 (which depend on
    neither attention nor experts) within CACHE_TOL of the tensor's
    largest magnitude, page table and lengths equal, one bsa_fwd launch a
    layer, finite logits — at the served config and where the two are the
    same function: attention budgets that cover the prompt (MRA-2 selects
    every causal block, the chunk kernel all 32 pages) and capacity_factor
    = E / top_k (the expert capacity depends on a call's tokens, so a whole
    4096-token pass and 128-token chunks drop different assignments
    otherwise). There the last logits of a one-layer pass are held within
    LOGIT_TOL, and every layer's cache error of the four-layer pass is
    reported: a chunk's queries early in block 0 take the stabilizer c
    from the block's mean key, which includes the chunk's later keys; with
    the reference's initialization (scores of order 100) exp(s - c) can
    underflow and the chunk path (the reference's too) zeroes such a row
    that the whole-prompt pass computes exactly, and layers past 0 carry
    the difference."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import EngineConfig, Request
    from repro_torch.serve.cache import RingPagedKVCache

    result = {}
    small = get_smoke_config(MOE_ARCH, activ_dtype="float32")
    params = init_params(small, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=3, max_len=64, chunk=8)
    streams = [_streams(torch, chunk_attn, small, params, ecfg, _requests(
        Request, (19, 3, 10, 40, 50), 60, small.vocab), plain)
        for plain in (False, True)]
    same = all(np.array_equal(streams[0][n], streams[1][n]) for n in streams[0])
    result["smoke"] = {"identical_streams": same, "requests": len(streams[0])}
    if not same:
        raise AssertionError("MoE smoke-size greedy streams differ kernel vs "
                             "plain")
    del params

    full4 = get_config(MOE_ARCH, num_layers=4, activ_dtype="float32")
    params = init_params(full4, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=4, max_len=4096, chunk=128)
    streams = [_streams(torch, chunk_attn, full4, params, ecfg, _requests(
        Request, SERVE["prompts"], 16, full4.vocab), plain)
        for plain in (False, True)]
    first = all(streams[0][n][0] == streams[1][n][0] for n in streams[0])
    agree = np.mean([np.mean(streams[0][n] == streams[1][n])
                     for n in streams[0]])
    result["full_width_4_layers"] = {"first_tokens_match": bool(first),
                                     "token_agreement": float(agree)}
    if not first:
        raise AssertionError("MoE full-width first tokens differ kernel vs "
                             "plain")

    S, C = 4096, 128
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, full4.vocab, (1, S)), device=DEVICE)
    nb = S // full4.attention.block_size
    exact = full4.replace(
        attention=full4.attention.replace(blocks_per_row=nb, decode_blocks=nb),
        moe=dataclasses.replace(full4.moe, capacity_factor=full4.moe.num_experts
                                / full4.moe.top_k))
    prefill = {}
    one = exact.replace(num_layers=1)
    one_params = dict(params, layers=params["layers"][:1])
    for label, cfg, p in (("exact", exact, params), ("served", full4, params),
                          ("exact_1_layer", one, one_params)):
        bsa.bsa_fwd.launches = 0
        whole = RingPagedKVCache(cfg, 1, S, device=DEVICE).tree
        lw, whole = transformer.prefill(p, cfg, {"tokens": toks}, whole)
        torch.cuda.synchronize()
        launches = bsa.bsa_fwd.launches
        chunked = RingPagedKVCache(cfg, 1, S, device=DEVICE).tree
        nv = torch.full((1,), C, dtype=torch.int32, device=DEVICE)
        for c0 in range(0, S, C):
            lc, chunked = transformer.prefill_chunk(p, cfg, chunked,
                                                    toks[:, c0:c0 + C], nv)
        torch.cuda.synchronize()
        errs = {key: [float((whole[key][i] - chunked[key][i]).abs().max())
                      / max(1.0, float(chunked[key][i].abs().max()))
                      for i in range(cfg.num_layers)]
                for key in ("k", "v", "pyr_k", "pyr_v")}
        same_tables = (torch.equal(whole["page_blocks"], chunked["page_blocks"])
                       and torch.equal(whole["lengths"], chunked["lengths"]))
        logit_err = float((lw - lc).abs().max())
        prefill[label] = {"layers": cfg.num_layers,
                          "bsa_fwd_launches": launches,
                          "cache_normwise_err_by_layer": errs,
                          "tables_equal": same_tables,
                          "logit_max_abs_err": logit_err,
                          "logits_finite": bool(torch.isfinite(lw).all())}
        layer0 = max(e[0] for e in errs.values())
        if launches != cfg.num_layers or not same_tables \
                or layer0 > CACHE_TOL or not prefill[label]["logits_finite"]:
            raise AssertionError(f"whole-prompt prefill ({label}) != "
                                 f"prefill_chunk: {prefill[label]}")
        if label == "exact_1_layer" and logit_err > LOGIT_TOL:
            raise AssertionError(f"whole-prompt prefill logits differ: "
                                 f"{logit_err}")
        del whole, chunked
    result["prefill_4096"] = {"prompt": S, "chunk": C, **prefill}
    emit({"phase": "moe_parity", "arch": MOE_ARCH, "dtype": "float32",
          **result})
    return prefill


# --------------------------------------------------------------------------- #
# training path: block-sparse attention kernels and the train loop
# --------------------------------------------------------------------------- #
BSA_KERNELS = ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv")


def _reset_bsa(bsa):
    for name in BSA_KERNELS:
        getattr(bsa, name).launches = 0


def _bsa_launches(bsa):
    return {name: getattr(bsa, name).launches for name in BSA_KERNELS}


def bsa_case(torch, sh, G, dtype, seed, edited, hot=False, causal=True,
             device_draws=False):
    """(q, k, v, c, x, y, flags, km, scale) for one comparison, numpy from
    ``seed``; pairs from a real MRA-2 selection (``select_blocks``), causal
    unless ``causal`` is false.
    ``edited`` pads the keys of batch row 1, invalidates every 7th pair and
    leaves query block 1 of BHG row 0 without pairs. ``hot`` makes the first
    nb pairs of every row (x, 0) for x = 0 .. nb - 1, so key tile 0 of each
    KV head walks G·nb pairs more than the rest. ``device_draws`` draws
    q / k / v on the device from the seed (numpy's draws take seconds at
    n = 524288)."""
    from repro_torch.core.mra import MraConfig, kernel_pairs, select_blocks

    r = np.random.default_rng(seed)
    B, Hq, n, d, b = (sh[k] for k in ("B", "Hq", "n", "d", "b"))
    Hkv = Hq // G
    shapes = ((B, Hkv, G, n, d), (B, Hkv, n, d), (B, Hkv, n, d))
    if device_draws:
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed)
        q, k, v = (torch.randn(s, generator=g, device=DEVICE).to(dtype)
                   for s in shapes)
    else:
        q, k, v = (torch.from_numpy(r.standard_normal(s, np.float32)).to(
            DEVICE, dtype) for s in shapes)
    lengths = np.array([n] + [n - (3 * b) // 2 if edited else n] * (B - 1))
    key_mask = torch.as_tensor(np.arange(n)[None] < lengths[:, None],
                               device=DEVICE)
    cfg = MraConfig(block_size=b, blocks_per_row=sh["bpr"], causal=causal)
    scale = d ** -0.5
    sel = select_blocks(q, k, v, key_mask, cfg, scale)
    c, x, y, flags = kernel_pairs(sel, causal=causal)
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
    worst, n, unvisited = {}, 0, 0
    dtypes = (torch.bfloat16, torch.float32)
    cases = [(sh, dtype, G, edited, False)
             for sh, dtype, G, edited in itertools.product(
                 (BSA_MAIN, BSA_SMOKE), dtypes, (1, 2), (False, True))]
    cases += [(sh, dtype, 2, False, hot)
              for (_, sh, hot), dtype in itertools.product(BSA_EXTRA, dtypes)]
    for sh, dtype, G, edited, hot in cases:
        n += 1
        errs, dead = _bsa_hold(torch, bsa, sh, G, dtype, SEED + n, edited,
                               hot=hot)
        worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
        unvisited += dead
    worst_mt = worst.pop("mt")
    emit({"phase": "bsa_vs_plain", "cases": n, "rtol": BSA_TOL,
          "atol": BSA_TOL, "mt_atol": MT_TOL, "max_abs_err": worst,
          "max_mt_err": worst_mt, "unvisited_rows": unvisited,
          "bit_identical_reruns": True})
    return worst


def _bsa_bounds(q, k, flags, nb, kernel):
    """Least time for one block-sparse call of ``kernel`` (``bsa_fwd``,
    ``bsa_bwd_dq``, ``bsa_bwd_dkv`` or the backward pair ``bwd_pair``):
    ``kernels/cost.py``'s bytes over HBM vs operations over the bf16
    tensor-core and the fp32 CUDA-core rates, with the pairs these flags
    make valid (bit0) and diagonal (bit1)."""
    from repro_torch.kernels import cost

    BHG, n, d = q.shape
    valid = (flags & 1) == 1
    diag = int((valid & ((flags & 2) == 2)).sum())
    out = cost.bsa_cost(kernel, BHG, k.shape[0], n, d, n // nb, flags.shape[1],
                        q.element_size(), int(valid.sum()) - diag, diag)
    for label, rate in (("bf16", cost.BF16_FLOP_PER_S),
                        ("fp32", cost.FP32_FLOP_PER_S)):
        out[f"bound_ms_{label}"], out[f"bound_by_{label}"] = cost.bound_ms(
            out["bytes"], out["flops"], rate)
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
    res = {"fwd": {"ms": time_ms(torch, lambda: bsa.bsa_fwd(
               q, k, v, c, pq, km, **kw), 20),
               "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_ref(
                   q, k, v, x, y, fl, c, km, **kw), 5),
               **_bsa_bounds(q, k, fl, nb, "bsa_fwd")}}
    plain_args = (q, k, v, c, x, y, fl, km, do, dr)
    res["dq"] = {"ms": time_ms(torch, lambda: bsa.bsa_bwd_dq(
        q, k, v, mt, do, dr, pq, km, **kw), 10),
        "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_bwd_dq_ref(
            *plain_args, **kw), 5),
        **_bsa_bounds(q, k, fl, nb, "bsa_bwd_dq")}
    res["dkv"] = {"ms": time_ms(torch, lambda: bsa.bsa_bwd_dkv(
        q, k, v, mt, do, dr, pk, km, **kw), 10),
        "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_bwd_dkv_ref(
            *plain_args, **kw), 5),
        **_bsa_bounds(q, k, fl, nb, "bsa_bwd_dkv")}
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
                       **_bsa_bounds(q, k, fl, nb, "bwd_pair")}
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


def phase_bsa_granite(torch, bsa):
    """bsa_fwd at (d, b) = (64, 128), G = 3 (granite-moe's whole-prompt
    prefill) against its plain twin, bf16 and fp32, twice and bit-identical
    (B = 2, with and without padded keys / invalid pairs); then its time at
    n = 4096, B = 1, bf16 beside its bound and the plain version's."""
    sh, worst, worst_mt, n = BSA_GRANITE, 0.0, 0.0, 0
    for dtype, edited in itertools.product((torch.bfloat16, torch.float32),
                                           (False, True)):
        n += 1
        q, k, v, c, x, y, fl, km, scale = bsa_case(
            torch, dict(sh, B=2), 3, dtype, SEED + 300 + n, edited)
        nb = sh["n"] // sh["b"]
        pq = bsa.group_by_query(x, y, fl, nb)
        kw = dict(scale=scale, block_size=sh["b"])
        runs = [bsa.bsa_fwd(q, k, v, c, pq, km, **kw) for _ in range(2)]
        ref = bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw)
        torch.cuda.synchronize()
        label = f"granite {dtype} edited={edited}"
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"bsa_fwd not bit-identical: {label}")
        out, rs, mt = runs[0]
        alive = rs > 0
        if not torch.equal(alive, ref[1] > 0):
            raise AssertionError(f"bsa_fwd live rows differ: {label}")
        norm_k = torch.where(alive[..., None], out, 0.0) / torch.where(
            alive, rs, 1.0)[..., None]
        norm_p = torch.where(alive[..., None], ref[0], 0.0) / torch.where(
            alive, ref[1], 1.0)[..., None]
        err = float((norm_k - norm_p).abs().max())
        mt_err = float((mt - ref[2]).abs().max())
        if not (bool(torch.isclose(norm_k, norm_p, rtol=BSA_TOL,
                                   atol=BSA_TOL).all())
                and bool(torch.isclose(rs, ref[1], rtol=BSA_TOL,
                                       atol=BSA_TOL).all())
                and mt_err <= MT_TOL and bool(torch.isfinite(out).all())):
            raise AssertionError(f"bsa_fwd != plain: {label}: {err}, mt "
                                 f"{mt_err}")
        worst, worst_mt = max(worst, err), max(worst_mt, mt_err)
    q, k, v, c, x, y, fl, km, scale = bsa_case(torch, sh, 3, torch.bfloat16,
                                               SEED, False)
    BHG, nseq, d = q.shape
    b, nb = sh["b"], nseq // sh["b"]
    pq = bsa.group_by_query(x, y, fl, nb)
    kw = dict(scale=scale, block_size=b)
    timing = {"ms": time_ms(torch, lambda: bsa.bsa_fwd(q, k, v, c, pq, km,
                                                       **kw), 50),
              "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_ref(
                  q, k, v, x, y, fl, c, km, **kw), 5),
              **_bsa_bounds(q, k, fl, nb, "bsa_fwd"),
              **bsa.launch_geometry("fwd", q.dtype, d, b, BHG * nb),
              "blocks_per_sm": bsa.blocks_per_sm("fwd", q.dtype, d, b)}
    emit({"phase": "bsa_granite", "kernel": "bsa_fwd", "shape": sh, "G": 3,
          "cases": n, "rtol": BSA_TOL, "atol": BSA_TOL, "mt_atol": MT_TOL,
          "max_abs_err": worst, "max_mt_err": worst_mt,
          "bit_identical_reruns": True, "timing_bf16": timing})
    if timing["blocks_per_sm"] < 2:
        raise AssertionError(f"bsa_fwd (64, 128) bf16 holds "
                             f"{timing['blocks_per_sm']} blocks an SM")
    return worst, timing


def phase_bsa_granite_bwd(torch, bsa):
    """bsa_bwd_dq and bsa_bwd_dkv at (d, b) = (64, 128), G = 3 (granite-moe's
    training) against their plain twins, bf16 and fp32, twice and
    bit-identical (with and without padded keys / invalid pairs); then
    their time at granite's training shape (B = 2, 24 / 8 heads, n = 4096,
    bf16) beside the bound and the plain twin, with grid, shared memory and
    blocks per SM (two or more in bf16, or the phase fails)."""
    sh = dict(BSA_GRANITE, B=TRAIN["batch"])
    nb = sh["n"] // sh["b"]
    worst, n = dict.fromkeys(("bsa_bwd_dq", "bsa_bwd_dkv"), 0.0), 0
    for dtype, edited in itertools.product((torch.bfloat16, torch.float32),
                                           (False, True)):
        n += 1
        q, k, v, c, x, y, fl, km, scale = bsa_case(torch, sh, 3, dtype,
                                                   SEED + 400 + n, edited)
        pq = bsa.group_by_query(x, y, fl, nb)
        pk = bsa.group_by_key(x, y, fl, 3, nb)
        kw = dict(scale=scale, block_size=sh["b"])
        mt = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)[2]
        r = np.random.default_rng(SEED + 500 + n)
        do = torch.from_numpy(r.standard_normal(tuple(q.shape), np.float32)).to(DEVICE)
        dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2]), np.float32)).to(DEVICE)
        runs = [(bsa.bsa_bwd_dq(q, k, v, mt, do, dr, pq, km, **kw),
                 *bsa.bsa_bwd_dkv(q, k, v, mt, do, dr, pk, km, **kw))
                for _ in range(2)]
        gref = bsa.block_sparse_attention_bwd_ref(q, k, v, c, x, y, fl, km,
                                                  do, dr, **kw)
        torch.cuda.synchronize()
        label = f"granite {dtype} edited={edited}"
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"bsa backward not bit-identical: {label}")
        for kname, got, want in (("bsa_bwd_dq", runs[0][0], gref[0]),
                                 ("bsa_bwd_dkv", runs[0][1], gref[1]),
                                 ("bsa_bwd_dkv", runs[0][2], gref[2])):
            err, ok = _scaled_close(torch, got, want, BSA_TOL)
            if not ok or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kname} != plain: {label}: {err}")
            worst[kname] = max(worst[kname], err)
    q, k, v, c, x, y, fl, km, scale = bsa_case(torch, sh, 3, torch.bfloat16,
                                               SEED, False)
    BHG, nseq, d = q.shape
    BHKV = k.shape[0]
    b = sh["b"]
    pq = bsa.group_by_query(x, y, fl, nb)
    pk = bsa.group_by_key(x, y, fl, 3, nb)
    kw = dict(scale=scale, block_size=b)
    mt = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)[2]
    r = np.random.default_rng(SEED)
    do = torch.from_numpy(r.standard_normal(tuple(q.shape), np.float32)).to(DEVICE)
    dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2]), np.float32)).to(DEVICE)
    plain_args = (q, k, v, c, x, y, fl, km, do, dr)
    timing = {
        "dq": {"ms": time_ms(torch, lambda: bsa.bsa_bwd_dq(
            q, k, v, mt, do, dr, pq, km, **kw), 20),
            "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_bwd_dq_ref(
                *plain_args, **kw), 5),
            **_bsa_bounds(q, k, fl, nb, "bsa_bwd_dq"),
            **bsa.launch_geometry("dq", q.dtype, d, b, BHG * nb),
            "blocks_per_sm": bsa.blocks_per_sm("dq", q.dtype, d, b)},
        "dkv": {"ms": time_ms(torch, lambda: bsa.bsa_bwd_dkv(
            q, k, v, mt, do, dr, pk, km, **kw), 20),
            "plain_ms": time_ms(torch, lambda: bsa.block_sparse_attention_bwd_dkv_ref(
                *plain_args, **kw), 5),
            **_bsa_bounds(q, k, fl, nb, "bsa_bwd_dkv"),
            **bsa.launch_geometry("dkv", q.dtype, d, b, BHKV * nb),
            "blocks_per_sm": bsa.blocks_per_sm("dkv", q.dtype, d, b)}}
    emit({"phase": "bsa_granite_bwd", "shape": sh, "G": 3, "cases": n,
          "rtol": BSA_TOL, "atol": BSA_TOL, "max_abs_err": worst,
          "bit_identical_reruns": True, "timing_bf16": timing})
    for key in ("dq", "dkv"):
        if timing[key]["blocks_per_sm"] < 2:
            raise AssertionError(f"bsa {key} (64, 128) bf16 holds "
                                 f"{timing[key]['blocks_per_sm']} blocks "
                                 "an SM")
    return worst, timing


def _bsa_hold(torch, bsa, sh, G, dtype, seed, edited, hot=False,
              causal=True):
    """The three kernels against their plain twins on one ``bsa_case``,
    each kernel run twice and bit-identical: (max |err| of the normalized
    numerator, of mt (held at MT_TOL) and of the max-scaled gradients, the
    rows no pair visits); raises on a disagreement."""
    q, k, v, c, x, y, fl, km, scale = bsa_case(torch, sh, G, dtype, seed,
                                               edited, hot=hot, causal=causal)
    b, nb = sh["b"], sh["n"] // sh["b"]
    pq = bsa.group_by_query(x, y, fl, nb)
    pk = bsa.group_by_key(x, y, fl, G, nb)
    kw = dict(scale=scale, block_size=b)
    runs = [bsa.bsa_fwd(q, k, v, c, pq, km, **kw) for _ in range(2)]
    ref = bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw)
    r = np.random.default_rng(seed + 100)
    do = torch.from_numpy(r.standard_normal(tuple(q.shape), np.float32)).to(DEVICE)
    dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2]), np.float32)).to(DEVICE)
    mt = runs[0][2]
    grads = [(bsa.bsa_bwd_dq(q, k, v, mt, do, dr, pq, km, **kw),
              *bsa.bsa_bwd_dkv(q, k, v, mt, do, dr, pk, km, **kw))
             for _ in range(2)]
    gref = bsa.block_sparse_attention_bwd_ref(q, k, v, c, x, y, fl, km,
                                              do, dr, **kw)
    torch.cuda.synchronize()
    label = (f"d={sh['d']} b={b} {dtype} G={G} causal={causal} "
             f"edited={edited} hot={hot}")
    for a, bb in zip(runs[0] + grads[0], runs[1] + grads[1]):
        if not torch.equal(a, bb):
            raise AssertionError(f"bsa kernels not bit-identical: {label}")
    out, rs, mt = runs[0]
    alive = rs > 0
    if not torch.equal(alive, ref[1] > 0):
        raise AssertionError(f"bsa_fwd live rows differ: {label}")
    if bool(out[~alive].any()) or bool(rs[~alive].any()):
        raise AssertionError(f"bsa_fwd dead rows not zero: {label}")
    norm_k = torch.where(alive[..., None], out, 0.0) / torch.where(
        alive, rs, 1.0)[..., None]
    norm_p = torch.where(alive[..., None], ref[0], 0.0) / torch.where(
        alive, ref[1], 1.0)[..., None]
    errs = {"bsa_fwd": float((norm_k - norm_p).abs().max()),
            "mt": float((mt - ref[2]).abs().max())}
    if not (bool(torch.isclose(norm_k, norm_p, rtol=BSA_TOL, atol=BSA_TOL).all())
            and bool(torch.isclose(rs, ref[1], rtol=BSA_TOL, atol=BSA_TOL).all())
            and errs["mt"] <= MT_TOL and bool(torch.isfinite(out).all())):
        raise AssertionError(f"bsa_fwd != plain: {label}: {errs}")
    for kname, got, want in (("bsa_bwd_dq", grads[0][0], gref[0]),
                             ("bsa_bwd_dkv", grads[0][1], gref[1]),
                             ("bsa_bwd_dkv", grads[0][2], gref[2])):
        err, ok = _scaled_close(torch, got, want, BSA_TOL)
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{kname} != plain: {label}: {err}")
        errs[kname] = max(errs.get(kname, 0.0), err)
    return errs, int((~alive).sum())


def _bsa_timing(torch, bsa, sh, G, causal):
    """Each kernel's time in bf16 at ``sh`` beside its plain twin's and its
    bounds (``_bsa_bounds``), with the launch's grid, block, shared memory
    and blocks an SM from the card's occupancy API."""
    q, k, v, c, x, y, fl, km, scale = bsa_case(
        torch, sh, G, torch.bfloat16, SEED, False, causal=causal)
    BHG, n, d = q.shape
    BHKV = k.shape[0]
    b, nb = sh["b"], n // sh["b"]
    pq = bsa.group_by_query(x, y, fl, nb)
    pk = bsa.group_by_key(x, y, fl, G, nb)
    kw = dict(scale=scale, block_size=b)
    mt = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)[2]
    r = np.random.default_rng(SEED)
    do = torch.from_numpy(r.standard_normal(tuple(q.shape), np.float32)).to(DEVICE)
    dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2]), np.float32)).to(DEVICE)
    plain_args = (q, k, v, c, x, y, fl, km, do, dr)
    cases = {
        "fwd": (lambda: bsa.bsa_fwd(q, k, v, c, pq, km, **kw),
                lambda: bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c,
                                                       km, **kw),
                "bsa_fwd", BHG * nb),
        "dq": (lambda: bsa.bsa_bwd_dq(q, k, v, mt, do, dr, pq, km, **kw),
               lambda: bsa.block_sparse_attention_bwd_dq_ref(*plain_args, **kw),
               "bsa_bwd_dq", BHG * nb),
        "dkv": (lambda: bsa.bsa_bwd_dkv(q, k, v, mt, do, dr, pk, km, **kw),
                lambda: bsa.block_sparse_attention_bwd_dkv_ref(*plain_args,
                                                               **kw),
                "bsa_bwd_dkv", BHKV * nb)}
    return {key: {"ms": time_ms(torch, fn, 20), "plain_ms": time_ms(torch, plain, 3),
                  **_bsa_bounds(q, k, fl, nb, kernel),
                  **bsa.launch_geometry(key, q.dtype, d, b, tiles),
                  "blocks_per_sm": bsa.blocks_per_sm(key, q.dtype, d, b)}
            for key, (fn, plain, kernel, tiles) in cases.items()}


def phase_bsa_hubert(torch, bsa, ptx):
    """bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at (d, b) = (80, 128), G = 1
    (hubert-xlarge's call) against their plain twins, non-causal and causal,
    bf16 and fp32, with and without padded keys / invalid pairs, each run
    twice and bit-identical; then their times in bf16 beside the bounds and
    the plain twins, with grid, shared memory, blocks per SM and ptxas'
    registers and spills. Fails below two blocks an SM in bf16 or on any
    spill of a D = 80 kernel."""
    sh = BSA_HUBERT
    worst, n = {}, 0
    _reset_bsa(bsa)
    for causal, dtype, edited in itertools.product(
            (False, True), (torch.bfloat16, torch.float32), (False, True)):
        n += 1
        errs, _ = _bsa_hold(torch, bsa, sh, 1, dtype, SEED + 600 + n, edited,
                            causal=causal)
        worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
    timing = {("non_causal" if not causal else "causal"):
              _bsa_timing(torch, bsa, sh, 1, causal) for causal in (False, True)}
    regs = [k for k in ptx if "D=80" in k["kernel"]]
    emit({"phase": "bsa_hubert", "shape": sh, "G": 1, "cases": n,
          "rtol": BSA_TOL, "atol": BSA_TOL, "mt_atol": MT_TOL,
          "max_abs_err": worst, "bit_identical_reruns": True,
          "phase_launches": _bsa_launches(bsa), "ptxas": regs,
          "timing_bf16": timing})
    low = [(c, key) for c, t in timing.items() for key in t
           if t[key]["blocks_per_sm"] < 2]
    spills = [k for k in regs if k["spill_stores"] or k["spill_loads"]]
    if low or spills or len(regs) != 6:
        raise AssertionError(f"bsa (80, 128): under two blocks an SM {low}, "
                             f"spills {spills}, {len(regs)} kernels built")
    return worst, timing


def phase_bsa_internvl(torch, bsa):
    """bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at (d, b) = (64, 128), G = 7
    (internvl2-1b's training call: B = 4, 14 query / 2 KV heads, n = 4096,
    causal) against their plain twins at phase 22's tolerances, bf16 and
    fp32, with and without padded keys / invalid pairs, each run twice and
    bit-identical; then their times in bf16 beside the bounds and the plain
    twins, with grid, shared memory and blocks per SM (two or more in bf16,
    or the phase fails)."""
    sh = BSA_VLM
    worst, n = {}, 0
    for dtype, edited in itertools.product((torch.bfloat16, torch.float32),
                                           (False, True)):
        n += 1
        errs, _ = _bsa_hold(torch, bsa, sh, 7, dtype, SEED + 700 + n, edited)
        worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
    timing = _bsa_timing(torch, bsa, sh, 7, True)
    emit({"phase": "bsa_internvl", "shape": sh, "G": 7, "cases": n,
          "rtol": BSA_TOL, "atol": BSA_TOL, "mt_atol": MT_TOL,
          "max_abs_err": worst, "bit_identical_reruns": True,
          "timing_bf16": timing})
    low = [key for key, t in timing.items() if t["blocks_per_sm"] < 2]
    if low:
        raise AssertionError(f"bsa (64, 128) bf16 under two blocks an SM: {low}")
    return worst, timing


def _attention_layers(cfg):
    """The layers that run the model's attention: every layer, or
    recurrentgemma's local ones (the rest are RG-LRU blocks)."""
    if cfg.family == "recurrentgemma":
        from repro_torch.models.recurrentgemma import layer_cache_kinds

        return layer_cache_kinds(cfg).count("window")
    return cfg.num_layers


def phase_train_full_width(torch, bsa, arch="qwen3-1.7b",
                           phase="train_full_width", batch=TRAIN["batch"],
                           cfg=None, steps=TRAIN["steps"]):
    """Three steps of ``train()`` at full width from random weights (the
    preset of ``arch``, or ``cfg``), the block-sparse kernels' launches
    counted over exactly that run (forward twice an attention layer a step
    under the presets' remat="full"). tokens_per_s counts the positions a
    step trains (hubert's frames, internvl's patches plus text)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.train import TrainConfig, train

    cfg = cfg or get_config(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=batch)
    tc = TrainConfig(steps=steps, seed=SEED)
    steps = []

    def on_metrics(step, m):
        steps.append({"step": step, "loss": m["loss"],
                      "aux_loss": m.get("aux_loss", 0.0),  # none: recurrent
                      "grad_norm": m["grad_norm"], "lr": m["lr"],
                      "seconds": m["step_time_s"],
                      "tokens_per_s": m["tokens_per_s"]})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_bsa(bsa)
    t0 = time.perf_counter()
    params, opt_state, _ = train(cfg, shape, tc, device=DEVICE,
                                 on_metrics=on_metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _bsa_launches(bsa)
    peak = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": phase, "arch": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "head_dim": cfg.hd, "param_dtype": cfg.param_dtype,
          "activ_dtype": cfg.activ_dtype,
          "remat": cfg.remat, "attention": dataclasses.asdict(cfg.attention),
          "seq_len": shape.seq_len, "batch": shape.global_batch,
          "tokens_per_s_counts": {"hubert": "frames",
                                  "internvl": "patches+text"}.get(cfg.family,
                                                                  "tokens"),
          "steps": steps, "wall_s": wall, "peak_gib": peak,
          "kernel_launches": launches})
    n_attn = _attention_layers(cfg)
    want = {"bsa_fwd": n_attn * tc.steps * 2,  # forward + remat
            "bsa_bwd_dq": n_attn * tc.steps,
            "bsa_bwd_dkv": n_attn * tc.steps}
    if launches != want:
        raise AssertionError(f"bsa launches {launches} != {want}")
    if not all(np.isfinite([s["loss"], s["grad_norm"], s["aux_loss"]]).all()
               for s in steps):
        raise AssertionError(f"non-finite loss or grad norm: {steps}")
    return launches, peak, (cfg, tc, shape, params, opt_state)


def phase_moe_train_full_width(torch, bsa):
    """granite-moe-3b-a800m's ``train()`` at batch 2; its peak must stay
    under the card's 80 GiB."""
    launches, peak, state = phase_train_full_width(
        torch, bsa, MOE_ARCH, "moe_train_full_width")
    if peak >= 80.0:
        raise AssertionError(f"granite training peaked at {peak} GiB")
    return launches, state


def phase_train_profile(torch, state, phase="train_profile", alone=True):
    """Where one full-width training step's time goes (kernel rows only);
    an MoE model's routed FFN runs inside a ``moe_block`` range (its
    forward and remat recompute: the backward's kernels fall outside)."""
    from repro_torch.data import make_batch
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step

    cfg, tc, shape, params, opt_state = state
    step_fn = make_train_step(cfg, tc, AdamW(), cosine_schedule(
        tc.lr, tc.warmup, tc.steps))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             make_batch(cfg, shape, step=tc.steps, seed=tc.seed).items()}
    ranges = ("moe_block",) if cfg.family == "moe" else ()
    orig_moe = transformer.moe_block

    def moe_block(*a, **kw):
        with torch.profiler.record_function("moe_block"):
            return orig_moe(*a, **kw)

    def step():
        nonlocal params, opt_state
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        float(metrics["loss"])

    with mock.patch.object(transformer, "moe_block", moe_block):
        emit({"phase": phase, "arch": cfg.name, "note": "ms per training "
              "step; device_ms = summed kernel time from torch.profiler",
              "train_step": _profile(torch, step, 1, kernels=BSA_KERNELS,
                                     ranges=ranges, warm=True, alone=alone)})


def _plain_twins(bsa):
    """Substitute the plain versions for the block-sparse kernels (here
    only)."""
    def fwd(q, k, v, c, x, y, fl, km, scale, block_size):
        return (*bsa.block_sparse_attention_ref(
            q, k, v, x, y, fl, c, km, scale=scale, block_size=block_size), None)

    def bwd(q, k, v, c, mt, pairs, x, y, fl, km, do, dr, scale, block_size):
        return bsa.block_sparse_attention_bwd_ref(
            q, k, v, c, x, y, fl, km, do, dr, scale=scale, block_size=block_size)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(bsa, "_forward", fwd))
    stack.enter_context(mock.patch.object(bsa, "_backward", bwd))
    return stack


def _check_route(bsa, plain, what):
    launches = sum(_bsa_launches(bsa).values())
    if (launches == 0) != plain:
        raise AssertionError(f"plain={plain} {what} made {launches} launches")


def _train_run(torch, bsa, cfg, shape, steps, plain):
    """[(loss, grad_norm)] of ``train()``; ``plain`` substitutes the plain
    versions for the kernels (here only)."""
    from repro_torch.train import TrainConfig, train

    out = []
    _reset_bsa(bsa)
    with _plain_twins(bsa) if plain else contextlib.nullcontext():
        train(cfg, shape, TrainConfig(steps=steps, seed=SEED, log_every=10**9),
              device=DEVICE,
              on_metrics=lambda s, m: out.append((m["loss"], m["grad_norm"])))
    _check_route(bsa, plain, "training")
    return np.array(out)


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _smoke_parity(torch, bsa, arch):
    """Three ``train()`` steps of the smoke config in fp32, kernels against
    their plain versions: losses within 1e-5."""
    from repro_torch.configs import SHAPES, get_smoke_config

    small = get_smoke_config(arch, activ_dtype="float32")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=256, global_batch=2)
    k, p = (_train_run(torch, bsa, small, shape, 3, plain) for plain in (False, True))
    result = {"steps": 3, "loss_kernel": k[:, 0].tolist(),
              "loss_plain": p[:, 0].tolist(), "loss_rel": _rel(k[:, 0], p[:, 0]),
              "grad_norm_rel": _rel(k[:, 1], p[:, 1])}
    if result["loss_rel"] > 1e-5:
        raise AssertionError(f"{arch} smoke training losses differ: {result}")
    return result


def phase_train_parity(torch, bsa):
    from repro_torch.configs import SHAPES, get_config

    result = {"smoke": _smoke_parity(torch, bsa, "qwen3-1.7b")}
    full4 = get_config("qwen3-1.7b", num_layers=4, activ_dtype="float32")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    k, p = (_train_run(torch, bsa, full4, shape, 1, plain) for plain in (False, True))
    result["full_width_4_layers"] = {
        "loss_kernel": float(k[0, 0]), "loss_plain": float(p[0, 0]),
        "grad_norm_kernel": float(k[0, 1]), "grad_norm_plain": float(p[0, 1]),
        "loss_rel": _rel(k[:, 0], p[:, 0]), "grad_norm_rel": _rel(k[:, 1], p[:, 1])}
    emit({"phase": "train_parity", "dtype": "float32", **result})
    f = result["full_width_4_layers"]
    if f["loss_rel"] > 1e-4 or f["grad_norm_rel"] > 1e-4:
        raise AssertionError(f"full-width training differs: {f}")


def _grads(torch, bsa, cfg, shape, plain):
    """Loss and every parameter's gradient of the first training batch,
    from the seed's weights, on the kernels or their plain versions (a
    config without MRA-2 layers launches none either way)."""
    from repro_torch.core.attention import MRA_KINDS

    from repro_torch.data import make_batch
    from repro_torch.models.params import init_params, tree_paths
    from repro_torch.models.registry import get_model

    params = init_params(cfg, seed=SEED, device=DEVICE)
    paths, leaves = zip(*tree_paths(params))
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             make_batch(cfg, shape, step=0, seed=SEED).items()}
    _reset_bsa(bsa)
    with _plain_twins(bsa) if plain else contextlib.nullcontext():
        loss, _ = get_model(cfg).loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    _check_route(bsa, plain or cfg.attention.kind not in MRA_KINDS,
                 "gradient")
    return float(loss.detach()), grads, ["/".join(map(str, p)) for p in paths]


def _grad_parity(torch, bsa, cfg, shape):
    """One batch's loss, gradient norm and every gradient leaf on the
    kernels against the plain versions, and the plain versions again:
    ``plain_rerun_bitwise`` says whether the rerun's loss and every
    gradient leaf are bitwise the first's (the plain twins sum in a fixed
    order). ``leaf_rel`` is the worst leaf's max |difference| over its
    largest |entry|."""
    def norm(gs):
        return float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))

    def leaf_rel(a, b):
        return [float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                for x, y in zip(a, b)]

    runs = [_grads(torch, bsa, cfg, shape, plain) for plain in (False, True)]
    rels = leaf_rel(runs[0][1], runs[1][1])
    out = {"layers": cfg.num_layers,
           "loss_kernel": runs[0][0], "loss_plain": runs[1][0],
           "grad_norm_kernel": norm(runs[0][1]),
           "grad_norm_plain": norm(runs[1][1]),
           "loss_rel": _rel(runs[0][0], runs[1][0]), "leaf_rel": max(rels),
           "worst_leaf": runs[0][2][int(np.argmax(rels))]}
    out["grad_norm_rel"] = _rel(out["grad_norm_kernel"], out["grad_norm_plain"])
    del runs[0]
    again = _grads(torch, bsa, cfg, shape, True)
    out["plain_rerun_leaf_rel"] = max(leaf_rel(again[1], runs[0][1]))
    out["plain_rerun_grad_norm_rel"] = _rel(norm(again[1]),
                                            out["grad_norm_plain"])
    out["plain_rerun_bitwise"] = (again[0] == runs[0][0] and all(
        torch.equal(a, b) for a, b in zip(again[1], runs[0][1])))
    return out


def _one_step(torch, bsa, cfg, shape):
    """One ``train()`` step on the kernels: its metrics, peak GiB (states
    included), launches, and the updated parameters."""
    from repro_torch.train import TrainConfig, train

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_bsa(bsa)
    out = []
    params, _, _ = train(cfg, shape, TrainConfig(steps=1, seed=SEED,
                                                 log_every=10**9),
                         device=DEVICE, on_metrics=lambda s, m: out.append(m))
    torch.cuda.synchronize()
    return {"loss": out[0]["loss"], "grad_norm": out[0]["grad_norm"],
            "step_s": out[0]["step_time_s"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": _bsa_launches(bsa)}, params


def phase_moe_train_parity(torch, bsa):
    """granite-moe's training parity, kernels against their plain versions
    in fp32: three smoke steps (losses within 1e-5); at full width, one
    batch's loss, grad norm and every gradient leaf at 1 layer, loss and
    grad norm at 2 layers, all within 1e-4; 4 layers reported (see
    MOE_PARITY). Then remat "none", "full" and "dots" on the kernels at full
    width with the depth cut to MOE_REMAT_LAYERS (one step each, bf16
    activations): loss and grad norm within 1e-6 of "none"'s, and "full"
    run twice to tell whether a rerun updates every parameter bitwise
    alike."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.params import tree_leaves

    result = {"smoke": _smoke_parity(torch, bsa, MOE_ARCH)}
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    for layers, keys in MOE_PARITY:
        cfg = get_config(MOE_ARCH, num_layers=layers, activ_dtype="float32")
        result[f"full_width_{layers}_layers"] = {
            **_grad_parity(torch, bsa, cfg, shape), "held": list(keys)}
        torch.cuda.empty_cache()
    emit({"phase": "moe_train_parity", "arch": MOE_ARCH, "dtype": "float32",
          "tolerance": 1e-4, **result})
    # the plain route reruns bitwise (its segment sums run in a fixed order)
    deepest = result[f"full_width_{MOE_PARITY[-1][0]}_layers"]
    f1 = {f"{layers}_layers": result[f"full_width_{layers}_layers"][
        "plain_rerun_bitwise"] for layers, _ in MOE_PARITY}
    emit({"phase": "plain_rerun_bitwise", "arch": MOE_ARCH,
          "dtype": "float32", "bitwise": f1,
          "kernel_vs_plain_deepest": {k: deepest[k] for k in (
              "layers", "loss_rel", "grad_norm_rel", "leaf_rel",
              "worst_leaf")}})
    if not all(f1.values()):
        raise AssertionError(f"the plain route's rerun is not bitwise: {f1}")
    for layers, keys in MOE_PARITY:
        f = result[f"full_width_{layers}_layers"]
        if any(f[k] > 1e-4 for k in keys):
            raise AssertionError(f"full-width training differs: {f}")
    base = get_config(MOE_ARCH, num_layers=MOE_REMAT_LAYERS)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    runs, kept = {}, None
    for policy in ("none", "full", "dots", "full"):
        run, params = _one_step(torch, bsa, base.replace(remat=policy), shape)
        if policy in runs:
            run["params_bitwise_as_first_run"] = all(
                torch.equal(a, b) for a, b in zip(kept, tree_leaves(params)))
            runs["full_rerun"] = run
        else:
            runs[policy] = run
            if policy == "full":
                kept = tree_leaves(params)
        del params
    kept = None
    worst = max(abs(runs[p][k] - runs["none"][k]) / abs(runs["none"][k])
                for p in ("full", "dots", "full_rerun")
                for k in ("loss", "grad_norm"))
    emit({"phase": "moe_remat_parity", "arch": MOE_ARCH,
          "layers": MOE_REMAT_LAYERS, "seq_len": shape.seq_len,
          "batch": shape.global_batch, "activ_dtype": base.activ_dtype,
          "max_rel_vs_none": worst, **runs})
    if worst > 1e-6:
        raise AssertionError(f"remat policies differ: {worst}")
    L = MOE_REMAT_LAYERS
    for policy, fwd in (("none", L), ("full", 2 * L), ("dots", 2 * L)):
        want = {"bsa_fwd": fwd, "bsa_bwd_dq": L, "bsa_bwd_dkv": L}
        if runs[policy]["launches"] != want:
            raise AssertionError(f"remat={policy}: launches "
                                 f"{runs[policy]['launches']} != {want}")


# --------------------------------------------------------------------------- #
# the hubert encoder and the internvl VLM at full width
# --------------------------------------------------------------------------- #
def _family_shape(arch):
    from repro_torch.configs import SHAPES

    return dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                               global_batch=FAMILY_BATCH[arch])


def _family_train(torch, bsa, arch, name):
    """``train()`` of the preset at full width, three steps at its batch cut,
    under the card's 80 GiB, then a profiled step; then one step at twice
    the batch, which must run out of memory (the cut is the largest power
    of two that fits)."""
    from repro_torch.configs import get_config
    from repro_torch.train import TrainConfig, train

    launches, peak, state = phase_train_full_width(
        torch, bsa, arch, f"{name}_train_full_width",
        batch=FAMILY_BATCH[arch], steps=FAMILY_STEPS[arch])
    if peak >= 80.0:
        raise AssertionError(f"{arch} training peaked at {peak} GiB")
    phase_train_profile(torch, state, phase=f"{name}_train_profile",
                        alone=FAMILY_PROFILE_ALONE[arch])
    del state
    torch.cuda.empty_cache()
    twice = dataclasses.replace(_family_shape(arch),
                                global_batch=2 * FAMILY_BATCH[arch])
    t0 = time.perf_counter()
    try:
        train(get_config(arch), twice, TrainConfig(steps=1, seed=SEED,
                                                   log_every=10**9),
              device=DEVICE)
        fits = True
    except torch.cuda.OutOfMemoryError:
        fits = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"phase": f"{name}_batch_cut", "arch": arch,
          "batch": FAMILY_BATCH[arch], "peak_gib": peak,
          "twice_the_batch": twice.global_batch, "twice_fits": fits,
          "probe_s": time.perf_counter() - t0})
    if fits:
        raise AssertionError(f"{arch}: batch {twice.global_batch} fits too; "
                             f"the cut to {FAMILY_BATCH[arch]} is not the "
                             "largest power of two")
    return launches


def phase_hubert(torch, bsa):
    """hubert-xlarge at full width (48 layers, 16 MHA heads of 80, non-causal
    MRA-2 at b = 128): a forward of a ``make_batch`` frame batch (finite
    logits over the 504-unit codebook, one bsa_fwd launch a layer); three
    ``train()`` steps at seq 4096 (remat="full"); then kernel against plain
    routes in fp32 at full width on one batch: loss, grad norm and every
    gradient leaf within 1e-4 at one layer, two layers reported."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    cfg = get_config(HUBERT_ARCH)
    shape = dataclasses.replace(_family_shape(HUBERT_ARCH), global_batch=2)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in make_batch(cfg, shape, seed=SEED).items()}
    _reset_bsa(bsa)
    with torch.no_grad():
        logits, _ = transformer.forward(params, cfg, batch)
    torch.cuda.synchronize()
    fwd = {"batch": 2, "seq_len": shape.seq_len,
           "logits_shape": list(logits.shape),
           "finite": bool(torch.isfinite(logits).all()),
           "masked_share": float(batch["mask_positions"].float().mean()),
           "kernel_launches": _bsa_launches(bsa)}
    del params, logits
    torch.cuda.empty_cache()
    emit({"phase": "hubert_forward", "arch": cfg.name, "layers": cfg.num_layers,
          "head_dim": cfg.hd, "causal": cfg.causal, **fwd})
    if (not fwd["finite"] or fwd["logits_shape"] != [2, shape.seq_len,
                                                     cfg.padded_vocab]
            or fwd["kernel_launches"] != {"bsa_fwd": cfg.num_layers,
                                          "bsa_bwd_dq": 0, "bsa_bwd_dkv": 0}):
        raise AssertionError(f"hubert forward: {fwd}")
    launches = _family_train(torch, bsa, HUBERT_ARCH, "hubert")
    _family_parity(torch, bsa, HUBERT_ARCH, "hubert")
    return launches


def _family_parity(torch, bsa, arch, name,
                   held=("loss_rel", "grad_norm_rel", "leaf_rel")):
    """Kernel against plain routes in fp32 at full width on one batch of 2
    at seq 4096: ``held`` within 1e-4 at one layer, the rest and two
    layers reported."""
    from repro_torch.configs import get_config

    shape = dataclasses.replace(_family_shape(arch), global_batch=2)
    result = {}
    for layers in (1, 2):
        one = get_config(arch, num_layers=layers, activ_dtype="float32")
        result[f"full_width_{layers}_layers"] = _grad_parity(torch, bsa, one,
                                                             shape)
        torch.cuda.empty_cache()
    emit({"phase": f"{name}_train_parity", "arch": arch,
          "dtype": "float32", "batch": shape.global_batch,
          "seq_len": shape.seq_len, "tolerance": 1e-4,
          "held_at_1_layer": list(held), **result})
    f = result["full_width_1_layers"]
    if any(f[k] > 1e-4 for k in held):
        raise AssertionError(f"{arch} full-width training differs: {f}")


def _vlm_prompt_decode(torch, bsa, chunk_attn, cfg, params, plain,
                       perturb=0.0):
    """internvl's whole-prompt prefill of VLM_PROMPT (patches + text), then
    greedy decode_steps: the tokens, each step's top-2 logit gap and top
    logit, launches, and the prefill and decode seconds. ``plain``
    substitutes the plain twins for both kernels (here only); ``perturb``
    scales the patches by 1 + perturb."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import make_batch
    from repro_torch.models import transformer
    from repro_torch.serve.cache import RingPagedKVCache

    sp = VLM_PROMPT
    shape = dataclasses.replace(SHAPES["train_4k"],
                                seq_len=cfg.num_patches + sp["text"],
                                global_batch=sp["slots"])
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
             make_batch(cfg, shape, seed=SEED + 1).items() if k != "targets"}
    batch["patches"] *= 1.0 + perturb

    def ref(pre, k_cache, v_cache, q_pos, **kw):
        return chunk_attn.chunk_attention_ref(pre, k_cache, v_cache, q_pos, **kw)

    _reset_bsa(bsa)
    _reset_chunk(chunk_attn)
    cache = RingPagedKVCache(cfg, sp["slots"], sp["max_len"],
                             device=DEVICE).tree
    toks, gaps = [], []
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
    with contextlib.ExitStack() as stack:
        if plain:
            stack.enter_context(_plain_twins(bsa))
            stack.enter_context(mock.patch.object(
                chunk_attn, "chunk_attention_kernel", ref))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = transformer.prefill(params, cfg, batch, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(sp["new_tokens"] + 1):
            top2 = torch.topk(logits[:, :cfg.vocab].float(), 2, dim=-1).values
            gaps.append(torch.stack([top2[:, 0] - top2[:, 1], top2[:, 0]], 1))
            bad.add_((~torch.isfinite(logits)).sum())
            tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)
            toks.append(tok)
            if i < sp["new_tokens"]:
                logits, cache = transformer.decode_step(params, cfg, cache, tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return {"tokens": torch.stack(toks, 1).cpu().numpy(),
            "gaps": torch.stack(gaps, 1).cpu().numpy(),
            "lengths": cache["lengths"].tolist(), "finite": int(bad) == 0,
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "bsa": _bsa_launches(bsa),
            "chunk": _chunk_launches(chunk_attn)[0],
            "combines": chunk_attn.chunk_attention_kernel.combine_launches
            if not plain else 0}


def _stream_diff(got, want):
    """Greedy streams of ``got`` against ``want``'s: the share of equal
    tokens, and per slot the first position where they part with
    ``want``'s top-2 logit gap there beside phase 14's limit, 4 bf16 ulps
    of its top logit (the prefixes are equal up to it)."""
    first = {}
    for s in range(got["tokens"].shape[0]):
        diff = np.flatnonzero(got["tokens"][s] != want["tokens"][s])
        if diff.size:
            i = int(diff[0])
            gap, top = want["gaps"][s, i]
            first[s] = {"position": i, "top2_gap": float(gap),
                        "limit_4_ulps": 4 * _bf16_ulp(top),
                        "top_logit": float(top)}
    return {"token_agreement": float(np.mean(got["tokens"] == want["tokens"])),
            "identical_streams": not first, "first_divergence": first}


def phase_internvl(torch, bsa, chunk_attn):
    """internvl2-1b at full width (24 layers, 14 query / 2 KV heads of 64,
    G = 7, causal MRA-2 at b = 128, vocab 151655): (a) three ``train()``
    steps at seq 4096 (256 patches + 3840 text tokens), then its fp32
    parity (``_family_parity``); (b) the whole-prompt prefill of 4 slots of
    patches + text, then 32 greedy decode steps, on the kernels (timed,
    launches counted); at VLM_PARITY_LAYERS, VLM_REPORT_LAYERS and full
    depth the streams kernel vs plain, plain vs a rerun of itself and
    plain vs plain with the patches scaled by 1 + VLM_PERTURB; at
    VLM_PARITY_LAYERS kernel vs plain held: equal, or parting only where
    the plain route's top-2 logit gap is under 4 bf16 ulps of its top
    logit (phase 14's rule); (c) phase 4's engine and text-only
    requests."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params

    train_launches = _family_train(torch, bsa, VLM_ARCH, "internvl")
    _family_parity(torch, bsa, VLM_ARCH, "internvl", VLM_PARITY_HELD)
    cfg = get_config(VLM_ARCH)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    # per depth: kernels, plain, plain again, plain on perturbed patches
    runs = {}
    for layers in (VLM_PARITY_LAYERS, *VLM_REPORT_LAYERS, cfg.num_layers):
        c = cfg.replace(num_layers=layers)
        p = dict(params, layers=params["layers"][:layers])
        runs[layers] = [_vlm_prompt_decode(torch, bsa, chunk_attn, c, p, plain,
                                           eps)
                        for plain, eps in ((False, 0.0), (True, 0.0),
                                           (True, 0.0), (True, VLM_PERTURB))]
    del params, p
    torch.cuda.empty_cache()
    n = VLM_PROMPT["new_tokens"]
    S = cfg.num_patches + VLM_PROMPT["text"]
    split = _splits(chunk_attn, cfg, VLM_PROMPT["slots"], 1,
                    VLM_PROMPT["max_len"])
    want_chunk = cfg.num_layers * n
    kern, plain = runs[cfg.num_layers][:2]
    streams = {layers: {
        "kernel_vs_plain": _stream_diff(k, pl),
        "plain_vs_plain_rerun": _stream_diff(again, pl),
        "plain_rerun_bitwise": bool(np.array_equal(again["gaps"], pl["gaps"])),
        "plain_vs_perturbed_plain": _stream_diff(pert, pl)}
        for layers, (k, pl, again, pert) in runs.items()}
    emit({"phase": "internvl_prompt_decode", "arch": cfg.name,
          "slots": VLM_PROMPT["slots"], "patches": cfg.num_patches,
          "text_tokens": VLM_PROMPT["text"], "new_tokens": n,
          "max_len": VLM_PROMPT["max_len"], "activ_dtype": cfg.activ_dtype,
          "prefill_s": kern["prefill_s"], "decode_s": kern["decode_s"],
          "decode_tok_per_s": VLM_PROMPT["slots"] * n / kern["decode_s"],
          "plain_prefill_s": plain["prefill_s"],
          "plain_decode_s": plain["decode_s"],
          "bsa_launches": kern["bsa"], "chunk_launches": kern["chunk"],
          "combine_launches": kern["combines"], "decode_split": split,
          "perturb": VLM_PERTURB, "held_layers": VLM_PARITY_LAYERS,
          "streams_by_layers": streams})
    if kern["bsa"] != {"bsa_fwd": cfg.num_layers, "bsa_bwd_dq": 0,
                       "bsa_bwd_dkv": 0} or kern["chunk"] != want_chunk \
            or kern["combines"] != (want_chunk if split else 0):
        raise AssertionError(f"internvl prompt + decode launches: bsa "
                             f"{kern['bsa']}, chunk {kern['chunk']} != "
                             f"{want_chunk}, combines {kern['combines']}")
    for layers, (k, *plains) in runs.items():
        if (k["bsa"]["bsa_fwd"] != layers or k["chunk"] != layers * n
                or any(r["bsa"] != dict.fromkeys(BSA_KERNELS, 0) or r["chunk"]
                       for r in plains)):
            raise AssertionError(f"{layers} layers: a route launched other "
                                 "kernels than its own")
        if any(r["lengths"] != [S + n] * VLM_PROMPT["slots"] or not r["finite"]
               for r in (k, *plains)):
            raise AssertionError(f"{layers} layers: lengths != {S + n}, or "
                                 "non-finite logits")
    held = streams[VLM_PARITY_LAYERS]["kernel_vs_plain"]
    for s, f in held["first_divergence"].items():
        if not f["top2_gap"] < f["limit_4_ulps"]:
            raise AssertionError(f"slot {s}: kernel stream leaves the plain "
                                 f"route's at {f} (no near tie)")
    engine_launches, eng, _ = phase_engine_full_width(
        torch, chunk_attn, arch=VLM_ARCH, phase="internvl_full_width",
        new_tokens=FAMILY_SERVE_TOKENS)
    del eng
    torch.cuda.empty_cache()
    return train_launches, engine_launches


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


def phase_upper_timing(torch, tmd, chunk_attn, sh=UP_MAIN,
                       phase="upper_timing"):
    """The H-level program (NU = 33) and the two-level one on the same
    4096-token bf16 windows of the long-context slice (``sh``: qwen3-1.7b's
    (128, 128), or granite-moe's (64, 128) with ``UP_GRANITE``), beside the
    bound and the plain version. The two slots' K/V (33.5 MB at D = 128)
    would stay in the 50 MB L2 across repeated calls, while the engine
    reads each layer's cache once per dispatch: every call here takes the
    next of ``L2_COPIES`` copies of the cache (134 MB in all at D = 128), so
    each finds its pages cold. The programs are timed in the order
    two-level, H-level, H-level, two-level and each keeps the mean of its
    two runs."""
    fn = chunk_attn.chunk_attention_kernel
    out = {}
    nu = 33
    for label, C, mode in (("decode", 1, "latency"),
                           ("chunk512", 512, "throughput")):
        pre2, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, sh, C,
                                                "dense", "bf16")
        pre = pre2._replace(upper=upper_view(torch, SEED, sh["B"],
                                             sh["Hkv"], sh["D"], nu,
                                             "all_live"))
        caches = [(k, v)] + [(k.clone(), v.clone())
                             for _ in range(L2_COPIES - 1)]
        turn = itertools.count()

        def cold(f, p):
            def call():
                kc, vc = caches[next(turn) % L2_COPIES]
                return f(p, kc, vc, q_pos, **kw)
            return call

        kw = dict(m=sh["m"], include_bg=True, mode=mode)
        iters = 200 if C == 1 else 20
        runs = [time_ms(torch, cold(fn, p), iters)
                for p in (pre2, pre, pre, pre2)]
        ms, two_ms = (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2
        plain_ms = time_ms(torch, cold(chunk_attn.chunk_attention_ref, pre),
                           10)
        del caches
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, sh["m"])
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
    emit({"phase": phase, "kernel": "chunk_attn_upper",
          "shape": sh, "nu": nu, "cache": "bf16",
          "layout": "dense 4096-token slots, L2-cold", **out})
    return out


def phase_long_context(torch, chunk_attn):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_config("qwen3-1.7b", num_layers=LONG_LAYERS)
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
          "prefill_s": _dispatch_seconds(eng, "prefill_chunk_seconds"),
          "context_tok_per_s": st["prefill_tokens"]
          / _dispatch_seconds(eng, "prefill_chunk_seconds"),
          "decode_dispatches": st["decode_dispatches"],
          "decode_s": _dispatch_seconds(eng, "decode_step_seconds"),
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


# --------------------------------------------------------------------------- #
# speculative serving: coarse-pyramid drafts, chunked verify, ring rewind
# --------------------------------------------------------------------------- #
def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(float(x)), 1e-30))) - 7)


def _count_dispatches(torch, transformer, chunk_attn, counts, bad):
    """Patches of prefill_chunk / decode_step that attribute the chunk
    kernel's launches and combines, and the dispatch itself, to its kind:
    draft (coarse-only decode), decode (a plain wave), verify (a chunk with
    collect_kv) or prefill; and count non-finite logits on the device."""
    fn = chunk_attn.chunk_attention_kernel
    orig = {"prefill_chunk": transformer.prefill_chunk,
            "decode_step": transformer.decode_step}

    def wrap(name):
        def wrapped(params, cfg, *a, **kw):
            l0, c0 = fn.launches + fn.upper_launches, fn.combine_launches
            res = orig[name](params, cfg, *a, **kw)
            if name == "decode_step":
                kind = "draft" if cfg.attention.coarse_only else "decode"
            else:
                kind = "verify" if kw.get("collect_kv") else "prefill"
            c = counts[kind]
            c["dispatches"] += 1
            c["launches"] += fn.launches + fn.upper_launches - l0
            c["combines"] += fn.combine_launches - c0
            bad.add_((~torch.isfinite(res[0])).sum())
            return res
        return wrapped

    return [mock.patch.object(transformer, n, wrap(n)) for n in orig]


def phase_spec_full_width(torch, chunk_attn, base):
    """Phase 4's requests through the speculative engine (spec_k = 4). The
    first crosses the ring boundary; whether a round lands in the K tokens
    before it (and a fallback wave runs) depends on the acceptance."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    K, n_new = SPEC["spec_k"], SPEC["new_tokens"]
    eng = Engine(cfg, params, EngineConfig(slots=4, max_len=4096, chunk=128,
                                           spec_k=K), device=DEVICE)
    reqs = _requests(Request, SERVE["prompts"], n_new, cfg.vocab)
    counts = {k: dict(dispatches=0, launches=0, combines=0)
              for k in ("prefill", "decode", "draft", "verify")}
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
    patches = _count_dispatches(torch, transformer, chunk_attn, counts, bad)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        _reset_chunk(chunk_attn)
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        upper = chunk_attn.chunk_attention_kernel.upper_launches
    st = eng.stats
    n_req = len(done)
    gen = st["generated_tokens"]
    full = st["verify_dispatches"] + st["decode_dispatches"]
    slot_rounds = st["spec_drafted_tokens"] // K
    plain_tokens = gen - n_req - st["spec_emitted_tokens"]
    per_dispatch = (gen - n_req) / full
    # streams against phase 4's: identical, or the first difference sits
    # where phase 4's top-2 logit gap is under 4 bf16 ulps of its top logit
    streams, first = {}, {}
    for r in done:
        n = len(r.prompt)
        streams[n] = np.asarray(r.out)
        diff = np.flatnonzero(streams[n] != base["streams"][n][:n_new])
        if diff.size:
            i = int(diff[0])
            gap, top = base["gaps"][n][i]
            first[n] = {"position": i, "top2_gap": float(gap),
                        "limit_4_ulps": 4 * _bf16_ulp(top),
                        "top_logit": float(top)}
    result = {
        "phase": "spec_full_width", "arch": cfg.name, "layers": cfg.num_layers,
        "activ_dtype": cfg.activ_dtype, "slots": 4, "max_len": 4096,
        "chunk": 128, "spec_k": K, "draft_budget_m": 1,
        "prompts": list(SERVE["prompts"]), "new_tokens": n_new,
        "wall_s": wall, "generated_tokens": gen, "tok_per_s": gen / wall,
        "plain_engine_tok_per_s": base["tok_per_s"],
        "spec_rounds": st["spec_rounds"],
        "drafted_tokens": st["spec_drafted_tokens"],
        "accepted_tokens": st["spec_accepted_tokens"],
        "emitted_tokens": st["spec_emitted_tokens"],
        "acceptance_rate": st["spec_accepted_tokens"]
        / max(st["spec_drafted_tokens"], 1),
        "slot_rounds": slot_rounds, "fallback_waves": st["decode_dispatches"],
        "fallback_wave_tokens": plain_tokens,
        # decode-side tokens per full-MRA dispatch (verifies + fallback
        # waves), against phase 4's per decode wave; and per slot, where
        # plain decoding gives exactly 1
        "tokens_per_full_dispatch": per_dispatch,
        "plain_tokens_per_dispatch": base["decode_tokens_per_dispatch"],
        "dispatch_gain": per_dispatch / base["decode_tokens_per_dispatch"],
        "tokens_per_slot_dispatch": (gen - n_req)
        / (slot_rounds + plain_tokens),
        "draft_s": _dispatch_seconds(eng, "draft_seconds"),
        "verify_s": _dispatch_seconds(eng, "verify_seconds"),
        "prefill_s": _dispatch_seconds(eng, "prefill_chunk_seconds"),
        "decode_wave_s": _dispatch_seconds(eng, "decode_step_seconds"),
        "by_kind": counts, "upper_launches": upper,
        "evicted_tokens": float(eng.kv.occupancy()["tokens_evicted"]),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "identical_streams": not first, "first_divergence": first}
    emit(result)
    for kind, c in counts.items():
        if c["launches"] != cfg.num_layers * c["dispatches"]:
            raise AssertionError(f"{kind}: {c['launches']} chunk-kernel "
                                 f"launches != {cfg.num_layers} x "
                                 f"{c['dispatches']} dispatches")
        C = {"prefill": 128, "verify": K + 1}.get(kind, 1)
        want = (cfg.num_layers * c["dispatches"]
                if _splits(chunk_attn, cfg, 4, C, 4096) else 0)
        if c["combines"] != want:
            raise AssertionError(f"{kind}: {c['combines']} combines != {want}")
    for kind, key in (("draft", "draft_dispatches"),
                      ("verify", "verify_dispatches"),
                      ("decode", "decode_dispatches"),
                      ("prefill", "prefill_dispatches")):
        if counts[kind]["dispatches"] != st[key]:
            raise AssertionError(f"{kind} dispatches {counts[kind]} != {key}")
    if upper or not st["spec_rounds"] or not result["evicted_tokens"]:
        raise AssertionError("no round, no ring crossing, or an H-level launch")
    if int(bad) != 0:
        raise AssertionError(f"{int(bad)} non-finite logits")
    if any(len(o) != n_new or int(o.min()) < 0 or int(o.max()) >= cfg.vocab
           for o in streams.values()):
        raise AssertionError("a stream is short or holds an out-of-vocab token")
    for n, f in first.items():
        if not f["top2_gap"] < f["limit_4_ulps"]:
            raise AssertionError(f"prompt {n}: speculative stream leaves phase "
                                 f"4's at {f} (no near tie)")
    return counts, eng


def phase_spec_profile(torch, eng):
    """Where a round's time goes, on the engine's cache after its run: one
    draft dispatch (coarse-only decode + draft sample), one verify dispatch
    (the (K+1)-chunk with all logits and its K/V + the accept step) and one
    snapshot + rewind pair."""
    from repro_torch.models import transformer
    from repro_torch.serve.sampling import draft_batch, spec_verify_batch

    B, K, spec = eng.slots, eng.spec_k, eng._spec
    vocab = eng.cfg.vocab
    host = [np.zeros(B, np.float32), np.zeros(B, np.int64),
            np.ones(B, np.float32), np.zeros(B, np.int64),
            np.zeros(B, np.int64)]
    toks = torch.arange(1, B + 1, device=DEVICE)
    active = torch.ones(B, dtype=torch.bool, device=DEVICE)
    chunk = (torch.arange(1, B * (K + 1) + 1, device=DEVICE)
             % vocab).reshape(B, K + 1)
    nv = torch.full((B,), K + 1, dtype=torch.int32, device=DEVICE)
    qs = torch.zeros((B, K, eng.cfg.padded_vocab), device=DEVICE)

    def draft():
        logits, _ = transformer.decode_step(eng.params, spec.dcfg, eng.kv.tree,
                                            toks, active=active)
        draft_batch(logits, *host, vocab=vocab)
        torch.cuda.synchronize()

    def verify():
        logits, _, _ = transformer.prefill_chunk(
            eng.params, eng.cfg, eng.kv.tree, chunk, nv, all_logits=True,
            collect_kv=True)
        out, _, _ = spec_verify_batch(logits, chunk[:, 1:], qs, *host[:4],
                                      host[4], active, vocab=vocab)
        out.cpu()

    def rewind():
        snap = eng.kv.spec_snapshot(K + 1)
        eng.kv.spec_rewind(snap, snap["lengths"], active)
        torch.cuda.synchronize()

    emit({"phase": "spec_profile", "note": "ms per dispatch; device_ms = "
          "summed kernel time from torch.profiler; busy_share = device_ms / "
          "wall_ms", "slots": B, "spec_k": K, "draft": _profile(torch, draft, 3),
          "verify": _profile(torch, verify, 3),
          "snapshot_rewind": _profile(torch, rewind, 3)})


def _park_for_rewind(cfg, params, Engine, EngineConfig, Request):
    """An engine whose two slots sit at lengths 30 and 12 of a 32-token
    window, so four draft steps of slot 0 cross the ring boundary."""
    eng = Engine(cfg, params, EngineConfig(slots=2, max_len=32, chunk=8),
                 device=DEVICE)
    eng.run([Request(prompt=np.arange(1, 9), max_new_tokens=23),
             Request(prompt=np.arange(3, 9), max_new_tokens=7)])
    return eng


def phase_spec_parity(torch, chunk_attn):
    """Speculative and telemetry parity on the card at the smoke size, fp32:
    greedy spec_k = 3 streams equal the plain engine's at H = 2 and H = 3,
    telemetry on and off give equal streams, and snapshot -> 4 draft steps
    -> rewind leaves every cache tensor bitwise as it was."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.serve.speculative import draft_config

    def h3(cfg):
        return cfg.replace(attention=cfg.attention.replace(levels=3))

    small = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
    params = init_params(small, seed=SEED, device=DEVICE)
    fn = chunk_attn.chunk_attention_kernel
    result = {}
    for label, cfg, ecfg, lens, n_new in (
            ("h2", small, EngineConfig(slots=3, max_len=64, chunk=8),
             (19, 3, 10, 40, 50), 60),
            ("h3", h3(small), EngineConfig(slots=2, max_len=64, chunk=32),
             (200, 37, 150, 90), 24)):
        runs = {}
        for key, ec in (("plain", ecfg), ("spec", ecfg.replace(spec_k=3)),
                        ("spec_no_telemetry",
                         ecfg.replace(spec_k=3, telemetry=False))):
            _reset_chunk(chunk_attn)
            eng = Engine(cfg, params, ec, device=DEVICE)
            done = eng.run(_requests(Request, lens, n_new, cfg.vocab))
            runs[key] = {len(r.prompt): np.asarray(r.out) for r in done}
            if fn.launches + fn.upper_launches == 0:
                raise AssertionError(f"{label} {key}: no kernel launch")
            if key == "spec":
                rounds = eng.stats["spec_rounds"]
                accepted = eng.stats["spec_accepted_tokens"]
        same = {k: all(np.array_equal(runs[k][n], runs["plain"][n])
                       for n in runs["plain"]) for k in runs}
        result[label] = {"spec_equals_plain": same["spec"],
                         "telemetry_off_equals_on": all(np.array_equal(
                             runs["spec_no_telemetry"][n], runs["spec"][n])
                             for n in runs["spec"]),
                         "spec_rounds": rounds, "accepted_tokens": accepted,
                         "requests": len(runs["plain"])}
        if not (same["spec"] and result[label]["telemetry_off_equals_on"]
                and rounds > 0):
            raise AssertionError(f"{label}: speculative streams differ: "
                                 f"{result[label]}")
    rewinds = {}
    for label, cfg in (("h2", small), ("h2_int8", small.replace(
            attention=small.attention.replace(kv_quant=True))),
            ("h3", h3(small))):
        eng = _park_for_rewind(cfg, params, Engine, EngineConfig, Request)
        before = {(k, i): a.clone() for k, v in eng.kv.tree.items()
                  for i, a in enumerate(v if isinstance(v, list) else [v])}
        act = torch.ones(2, dtype=torch.bool, device=DEVICE)
        snap = eng.kv.spec_snapshot(5)
        tok = torch.tensor([7, 9], device=DEVICE)
        for _ in range(4):
            logits, _ = transformer.decode_step(params, draft_config(cfg),
                                                eng.kv.tree, tok, active=act)
            tok = torch.argmax(logits[:, :cfg.vocab], -1)
        moved = int(eng.kv.lengths[0]) == 34
        eng.kv.spec_rewind(snap, snap["lengths"], act)
        after = {(k, i): a for k, v in eng.kv.tree.items()
                 for i, a in enumerate(v if isinstance(v, list) else [v])}
        exact = all(torch.equal(after[k], before[k]) for k in before)
        rewinds[label] = {"drafts_advanced": moved, "bitwise_equal": exact,
                          "tensors": len(before)}
        if not (moved and exact):
            raise AssertionError(f"rewind {label}: {rewinds[label]}")
    emit({"phase": "spec_parity", **result, "rewind": rewinds})


# --------------------------------------------------------------------------- #
# the paper's baselines (phase 27)
# --------------------------------------------------------------------------- #
def structured_qkv(rng, B=1, H=8, N=512, D=64, *, n_clusters=12,
                   locality=0.7, n_global=4, scale=1.0):
    """Q/K/V with trained-transformer-like attention (banded drift, content
    clusters, a few global keys): this script's own copy of the
    approximation protocol's inputs (``benchmarks/common.py``), numpy."""
    t = np.linspace(0, 6 * np.pi, N)
    drift = np.stack([np.sin(t + p) for p in np.linspace(0, np.pi, D // 2)], -1)
    drift = np.concatenate([drift, np.cos(drift)], -1)[:, :D]  # (N, D)
    centers = rng.standard_normal((n_clusters, D))
    assign = np.sort(rng.integers(0, n_clusters, N))
    content_q = centers[assign] + 0.4 * rng.standard_normal((N, D))
    content_k = centers[assign] + 0.4 * rng.standard_normal((N, D))

    def mix(content):
        out = np.zeros((B, H, N, D), np.float32)
        for b in range(B):
            for h in range(H):
                w = locality * (0.5 + rng.random())
                noise = 0.3 * rng.standard_normal((N, D))
                out[b, h] = (w * drift + (1 - w) * content + noise) * scale
        return out

    q = mix(content_q)
    k = mix(content_k)
    gidx = rng.integers(0, N, n_global)
    k[:, :, gidx] *= 3.0
    v = rng.standard_normal((B, H, N, D)).astype(np.float32)
    return q, k, v


def rel_error(torch, approx, q, k, v):
    """The paper's metric: ||approx - exact||_F / ||exact||_F."""
    from repro_torch.core.mra import full_attention

    ref = full_attention(q, k, v)
    return float(torch.linalg.norm(approx.float() - ref)
                 / torch.linalg.norm(ref))


def phase_baselines(torch, bsa, ptx):
    """The six baselines on the reference's Fig. 4 / Tab. 7 inputs
    (``structured_qkv(default_rng(0), B=1, H=8, N=512, D=64)``): each on
    the card against the same call on the CPU (the same default draws, made
    on the CPU generator) within 1e-4 of the output's largest magnitude,
    its ``rel_error`` against exact attention, the deterministic three
    within 1e-3 of the reference's rows, H-Transformer-1D's exact term
    through bsa_fwd at (64, 32) (its launch counted); then the three
    block-sparse kernels at (64, 32), G = 1, non-causal, against their
    plain twins (bf16 and fp32, with and without padded keys / invalid
    pairs, reruns bit-identical) and timed in bf16."""
    from repro_torch.core import baselines

    q, k, v = structured_qkv(np.random.default_rng(0), **BASELINE)
    cpu = [torch.from_numpy(a) for a in (q, k, v)]
    card = [a.to(DEVICE) for a in cpu]
    rows = {}
    _reset_bsa(bsa)
    for kind in BASELINE_KINDS:
        fn = baselines.REGISTRY[kind]
        before = _bsa_launches(bsa)["bsa_fwd"]
        got = fn(*card)
        torch.cuda.synchronize()
        launches = _bsa_launches(bsa)["bsa_fwd"] - before
        want = fn(*cpu)
        rows[kind] = {
            "card_vs_cpu_rel": float((got.cpu() - want).abs().max()
                                     / want.abs().max()),
            "rel_error": rel_error(torch, got, *card),
            "finite": bool(torch.isfinite(got).all()),
            "bsa_fwd_launches": launches,
            "ms": time_ms(torch, lambda: fn(*card), 5)}
        if kind in BASELINE_REF:
            rows[kind]["reference_rel_error"] = BASELINE_REF[kind]
    h1d_launches = rows["h_transformer_1d"]["bsa_fwd_launches"]
    worst, n = {}, 0
    for dtype, edited in itertools.product((torch.bfloat16, torch.float32),
                                           (False, True)):
        n += 1
        errs, _ = _bsa_hold(torch, bsa, BSA_H1D, 1, dtype, SEED + 700 + n,
                            edited, causal=False)
        worst = {key: max(worst.get(key, 0.0), e) for key, e in errs.items()}
    timing = _bsa_timing(torch, bsa, BSA_H1D, 1, causal=False)
    regs = [r for r in ptx if "D=64 b=32" in r["kernel"]]
    emit({"phase": "baselines", "inputs": {"structured_qkv": BASELINE,
                                           "seed": 0},
          "tolerance_card_vs_cpu": 1e-4, "tolerance_reference": 1e-3,
          "rows": rows, "bsa_h1d": {"shape": BSA_H1D, "G": 1, "cases": n,
                                    "max_abs_err": worst,
                                    "bit_identical_reruns": True,
                                    "ptxas": regs, "timing_bf16": timing}})
    bad = [kind for kind, r in rows.items()
           if r["card_vs_cpu_rel"] > 1e-4 or not r["finite"]
           or abs(r["rel_error"] - r.get("reference_rel_error",
                                         r["rel_error"])) > 1e-3
           or r["bsa_fwd_launches"] != (kind == "h_transformer_1d")]
    if bad or len(regs) != 6:
        raise AssertionError(f"baselines {bad} fail; {len(regs)} (64, 32) "
                             "kernels built")
    return h1d_launches, worst, timing


# --------------------------------------------------------------------------- #
# the rwkv6 family (phases 28-30)
# --------------------------------------------------------------------------- #
def _param_count(params):
    from repro_torch.models.params import tree_leaves

    return sum(p.numel() for p in tree_leaves(params))


def phase_rwkv_full_width(torch):
    """rwkv6-7b at full width served by phase 4's engine and requests
    through the recurrent state cache (the first request runs past
    max_len): tok/s, prefill / decode seconds, peak GiB; every logit
    finite, every stream full length."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_config(RWKV_ARCH)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(slots=4, max_len=4096, chunk=128),
                 device=DEVICE)
    reqs = _requests(Request, SERVE["prompts"], SERVE["new_tokens"], cfg.vocab)
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)

    def finite(fn):
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(rwkv6, "prefill_chunk", finite(rwkv6.prefill_chunk)), \
            mock.patch.object(rwkv6, "decode_step", finite(rwkv6.decode_step)):
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = eng.stats
    lengths = eng.kv.lengths
    emit({"phase": "rwkv_full_width", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.d_model // cfg.rwkv_head_dim,
          "head_dim": cfg.rwkv_head_dim, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "params": _param_count(params),
          "param_dtype": cfg.param_dtype, "activ_dtype": cfg.activ_dtype,
          "cache": type(eng.kv).__name__, "capacity": eng.kv.capacity,
          "slots": 4, "max_len": 4096, "chunk": 128,
          "prompts": list(SERVE["prompts"]), "new_tokens": SERVE["new_tokens"],
          "wall_s": wall, "generated_tokens": st["generated_tokens"],
          "tok_per_s": st["generated_tokens"] / wall,
          "prefill_tokens": st["prefill_tokens"],
          "prefill_dispatches": st["prefill_dispatches"],
          "prefill_s": _dispatch_seconds(eng, "prefill_chunk_seconds"),
          "decode_dispatches": st["decode_dispatches"],
          "decode_s": _dispatch_seconds(eng, "decode_step_seconds"),
          "final_lengths": lengths.tolist(),
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    if int(bad) != 0:
        raise AssertionError(f"{int(bad)} non-finite logits")
    if type(eng.kv).__name__ != "RecurrentStateCache" or int(lengths.max()) <= 4096:
        raise AssertionError(f"{type(eng.kv).__name__}: no stream ran past "
                             f"max_len ({lengths.tolist()})")
    if any(len(r.out) != SERVE["new_tokens"] or int(r.out.min()) < 0
           or int(r.out.max()) >= cfg.vocab for r in done):
        raise AssertionError("a stream is short or holds an out-of-vocab token")
    return eng, {len(r.prompt): np.asarray(r.out) for r in done}


def _on(tree, device):
    from repro_torch.models.params import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [p.to(device) for p in tree_leaves(tree)])


def phase_rwkv_self(torch):
    """rwkv6 on the card against itself: ``wkv_chunked`` against
    ``wkv_scan`` at the full-width head shape (the reference test's 1e-4 of
    the output's largest magnitude) and both timed; the whole-prompt
    ``prefill`` then decoding against stepwise decoding at 2 full-width
    layers (the reference test's tolerances, fp32 held, bf16 reported);
    greedy streams of a 2-layer full-width engine on the card against the
    same engine on the CPU, fp32, equal or parting only at an fp32 near
    tie (top-2 gap under 1e-4 of the top logit)."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request, Scheduler
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.cache import RecurrentStateCache

    sh = RWKV_WKV
    r = np.random.default_rng(SEED)
    shape = (sh["B"], sh["H"], sh["T"], sh["dh"])
    rkv = [torch.from_numpy(r.standard_normal(shape, np.float32)).to(DEVICE)
           for _ in range(3)]
    lw = torch.from_numpy(np.maximum(
        -np.exp(r.standard_normal(shape)), -rwkv6._decay_clamp(sh["chunk"])
    ).astype(np.float32)).to(DEVICE)
    u = torch.from_numpy(r.standard_normal((sh["H"], sh["dh"]),
                                           np.float32)).to(DEVICE)
    with torch.no_grad():
        y_c = rwkv6.wkv_chunked(*rkv, lw, u, sh["chunk"])
        y_s = rwkv6.wkv_scan(*rkv, lw, u)
        wkv = {"shape": sh, "rel_err": float((y_c - y_s).abs().max()
                                             / y_s.abs().max()),
               "chunked_ms": time_ms(
                   torch, lambda: rwkv6.wkv_chunked(*rkv, lw, u, sh["chunk"]), 5),
               "scan_ms": time_ms(torch, lambda: rwkv6.wkv_scan(*rkv, lw, u), 1),
               "chunks": sh["T"] // sh["chunk"]}
    del rkv, lw, y_c, y_s

    cont = {}
    for adt in ("float32", "bfloat16"):
        cfg = get_config(RWKV_ARCH, num_layers=2, activ_dtype=adt)
        params = init_params(cfg, seed=SEED, device=DEVICE)
        B, S = 2, 2 * cfg.rwkv_chunk
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            1, cfg.vocab, (B, S)).astype(np.int32)).to(DEVICE)
        with torch.no_grad():
            lp, cp = rwkv6.prefill(params, cfg, {"tokens": toks},
                                   RecurrentStateCache(cfg, rwkv6, B, S,
                                                       device=DEVICE).tree)
            cd = RecurrentStateCache(cfg, rwkv6, B, S, device=DEVICE).tree
            for t in range(S):
                ld, cd = rwkv6.decode_step(params, cfg, cd, toks[:, t])
        state_ok = torch.allclose(cp["state"], cd["state"], atol=1e-3, rtol=1e-2)
        logit_ok = torch.allclose(lp.float(), ld.float(), atol=0.05, rtol=0.05)
        cont[adt] = {"state_max_abs": float((cp["state"] - cd["state"]).abs().max()),
                     "logits_max_abs": float((lp.float() - ld.float()).abs().max()),
                     "within_reference_tolerances": bool(state_ok and logit_ok)}
        del params, cp, cd
    torch.cuda.empty_cache()

    cfg = get_config(RWKV_ARCH, num_layers=2, activ_dtype="float32")
    host = init_params(cfg, seed=SEED, device="cpu")
    ecfg = EngineConfig(slots=4, max_len=4096, chunk=128)
    streams = {}
    (p_sample, p_sched), gaps = _top2_recorder(torch, engine_mod, Scheduler,
                                               cfg.vocab)
    for where, params in (("cpu", host), (DEVICE, _on(host, DEVICE))):
        reqs = _requests(Request, RWKV_STREAMS["prompts"],
                         RWKV_STREAMS["new_tokens"], cfg.vocab)
        with (p_sample if where == DEVICE else contextlib.nullcontext()), \
                (p_sched if where == DEVICE else contextlib.nullcontext()):
            done = Engine(cfg, params, ecfg, device=where).run(reqs)
        streams[where] = {len(q.prompt): np.asarray(q.out) for q in done}
    parts = {}
    for n, want in streams["cpu"].items():
        got = streams[DEVICE][n]
        diff = np.flatnonzero(got != want)
        if len(diff):
            j = int(diff[0])
            gap, top = (float(x) for x in gaps[n][j])
            parts[n] = {"token": j, "gap": gap, "top": top,
                        "near_tie": gap <= 1e-4 * max(abs(top), 1.0)}
    emit({"phase": "rwkv_self", "arch": RWKV_ARCH, "wkv": wkv,
          "prefill_vs_stepwise_2_layers": cont,
          "streams_card_vs_cpu": {"layers": 2, "activ_dtype": "float32",
                                  "prompts": list(RWKV_STREAMS["prompts"]),
                                  "new_tokens": RWKV_STREAMS["new_tokens"],
                                  "equal": not parts, "parts": parts}})
    if wkv["rel_err"] > 1e-4:
        raise AssertionError(f"wkv_chunked vs wkv_scan: {wkv}")
    if not cont["float32"]["within_reference_tolerances"]:
        raise AssertionError(f"prefill vs stepwise decode: {cont}")
    if any(not p["near_tie"] for p in parts.values()):
        raise AssertionError(f"card and CPU streams part: {parts}")


def _rwkv_train(torch, cfg, shape, steps):
    from repro_torch.train import TrainConfig, train

    tc = TrainConfig(steps=steps, seed=SEED)
    out = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, _ = train(cfg, shape, tc, device=DEVICE,
                                 on_metrics=lambda s, m: out.append(
                                     {"step": s, "loss": m["loss"],
                                      "grad_norm": m["grad_norm"],
                                      "lr": m["lr"],
                                      "seconds": m["step_time_s"],
                                      "tokens_per_s": m["tokens_per_s"]}))
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30,
            (cfg, tc, shape, params, opt_state))


def phase_rwkv_train(torch):
    """rwkv6-7b ``train()`` at full width with the depth cut to
    RWKV_TRAIN_LAYERS (the largest that fits fp32 weights, gradients and
    two AdamW moments beside the activations): three steps at seq 4096,
    batch 2, the preset's remat="full"; a profiled step; one step at one
    layer more, which must run out of memory; then, in fp32 at one
    full-width layer on one batch, loss and grad norm of the chunked route
    against ``use_scan=True`` within 1e-4."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import make_batch
    from repro_torch.models import layers as L
    from repro_torch.models import rwkv6
    from repro_torch.models.params import init_params, tree_leaves

    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    cfg = get_config(RWKV_ARCH, num_layers=RWKV_TRAIN_LAYERS)
    steps, wall, peak, state = _rwkv_train(torch, cfg, shape, TRAIN["steps"])
    emit({"phase": "rwkv_train_full_width", "arch": cfg.name,
          "layers": cfg.num_layers, "full_depth": 32,
          "params": _param_count(state[3]), "d_model": cfg.d_model,
          "param_dtype": cfg.param_dtype, "activ_dtype": cfg.activ_dtype,
          "remat": cfg.remat, "seq_len": shape.seq_len,
          "batch": shape.global_batch, "steps": steps, "wall_s": wall,
          "peak_gib": peak})
    if peak >= 80.0 or not all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                               for s in steps):
        raise AssertionError(f"rwkv6 training: peak {peak} GiB, {steps}")
    phase_train_profile(torch, state, phase="rwkv_train_profile")
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        _rwkv_train(torch, cfg.replace(num_layers=RWKV_TRAIN_LAYERS + 1),
                    shape, 1)
        fits = True
    except torch.cuda.OutOfMemoryError:
        fits = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"phase": "rwkv_depth_cut", "layers": RWKV_TRAIN_LAYERS,
          "peak_gib": peak, "one_more_fits": fits,
          "probe_s": time.perf_counter() - t0})
    if fits:
        raise AssertionError(f"{RWKV_TRAIN_LAYERS + 1} layers fit too; the "
                             f"cut to {RWKV_TRAIN_LAYERS} is not the largest")

    one = get_config(RWKV_ARCH, num_layers=1, activ_dtype="float32",
                     remat="none")
    sshape = dataclasses.replace(shape, seq_len=RWKV_SCAN_SEQ)
    params = init_params(one, seed=SEED, device=DEVICE)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in make_batch(one, sshape, seed=SEED).items()}
    runs = {}
    for use_scan in (False, True):
        logits, _ = rwkv6.forward(params, one, batch, use_scan=use_scan)
        loss = L.lm_nll(logits, batch["targets"], one).mean()
        grads = torch.autograd.grad(loss, leaves)
        runs[use_scan] = (float(loss.detach()), float(torch.sqrt(
            sum((g.double() ** 2).sum() for g in grads))))
        del logits, loss, grads
    parity = {"layers": 1, "seq_len": RWKV_SCAN_SEQ, "batch": 2,
              "loss_chunked": runs[False][0], "loss_scan": runs[True][0],
              "grad_norm_chunked": runs[False][1],
              "grad_norm_scan": runs[True][1],
              "loss_rel": _rel(runs[False][0], runs[True][0]),
              "grad_norm_rel": _rel(runs[False][1], runs[True][1])}
    emit({"phase": "rwkv_train_parity", "dtype": "float32",
          "tolerance": 1e-4, **parity})
    if parity["loss_rel"] > 1e-4 or parity["grad_norm_rel"] > 1e-4:
        raise AssertionError(f"chunked vs scan training differs: {parity}")


# --------------------------------------------------------------------------- #
# the recurrentgemma family (phases 31-34)
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def _expandable_segments(torch):
    """The caching allocator with ``expandable_segments`` for the duration:
    segments grow in place, so whether a step fits is a matter of the
    bytes it holds, not of how the cache happens to be split (near the
    card's limit, the default allocator's fragmentation decided it one
    way or the other from run to run)."""
    from torch.cuda.memory import _set_allocator_settings

    def switch(on):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # a private setting
            _set_allocator_settings(f"expandable_segments:{on}")

    switch(True)
    try:
        yield
    finally:
        switch(False)


def _rgemma_mra(cfg):
    """The MRA-2 variant of a recurrentgemma config: its local layers
    through ``mra2_attention`` (the block-sparse kernels at (256, 128))."""
    from repro_torch.core.attention import AttentionSpec

    return cfg.replace(attention=AttentionSpec(**RGEMMA_MRA))


def phase_bsa_rgemma(torch, bsa, ptx):
    """bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at (d, b) = (256, 128), G = 16
    (recurrentgemma's MRA-2 training call: B = 2, 16 query heads over one
    KV head, n = 4096, causal), bf16 and fp32, with and without padded keys
    / invalid pairs, against their plain twins at phase 22's tolerances,
    reruns bit-identical; then their times in bf16 beside the bounds and
    the plain twins, with grid, threads, shared memory, blocks per SM and
    ptxas' registers and spills. Fails on a spill of a bf16 D = 256
    kernel."""
    sh = BSA_RGEMMA
    G = sh["Hq"]  # one KV head
    worst, n = {}, 0
    _reset_bsa(bsa)
    for dtype, edited in itertools.product((torch.bfloat16, torch.float32),
                                           (False, True)):
        n += 1
        errs, _ = _bsa_hold(torch, bsa, sh, G, dtype, SEED + 800 + n, edited)
        worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
    timing = _bsa_timing(torch, bsa, sh, G, True)
    regs = [k for k in ptx if "D=256" in k["kernel"]]
    emit({"phase": "bsa_rgemma", "shape": sh, "G": G, "cases": n,
          "rtol": BSA_TOL, "atol": BSA_TOL, "mt_atol": MT_TOL,
          "max_abs_err": worst, "bit_identical_reruns": True,
          "ptxas": regs, "timing_bf16": timing})
    spills = [k for k in regs if " bf16 " in k["kernel"]
              and (k["spill_stores"] or k["spill_loads"])]
    if spills or len(regs) != 6:
        raise AssertionError(f"bsa (256, 128): spilling bf16 kernels "
                             f"{spills}, {len(regs)} kernels built")
    return worst, timing


def phase_rgemma_full_width(torch):
    """recurrentgemma-9b at full width (38 layers, 8.53 B fp32 parameters
    from a seed, bf16 activations) served by phase 4's engine and requests
    through the window ring + RG-LRU state (the 3968- and 2500-token
    prompts wrap the 2048-entry ring): tok/s, prefill / decode seconds,
    peak GiB, occupancy; every logit finite, every stream full length."""
    from repro_torch.configs import get_config
    from repro_torch.models import recurrentgemma
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_config(RGEMMA_ARCH)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    eng = Engine(cfg, params, EngineConfig(slots=4, max_len=4096, chunk=128),
                 device=DEVICE)
    reqs = _requests(Request, SERVE["prompts"], FAMILY_SERVE_TOKENS, cfg.vocab)
    bad = torch.zeros((), dtype=torch.int64, device=DEVICE)

    def finite(fn):
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return wrapped

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(recurrentgemma, "prefill_chunk",
                           finite(recurrentgemma.prefill_chunk)), \
            mock.patch.object(recurrentgemma, "decode_step",
                              finite(recurrentgemma.decode_step)):
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = eng.stats
    lengths = eng.kv.lengths
    occ = eng.kv.occupancy()
    emit({"phase": "rgemma_full_width", "arch": cfg.name,
          "family": cfg.family, "layers": cfg.num_layers,
          "pattern": list(cfg.block_pattern), "d_model": cfg.d_model,
          "heads": cfg.num_heads, "kv_heads": cfg.kv_heads,
          "head_dim": cfg.hd, "lru_width": cfg.lru_width, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "local_window": cfg.local_window,
          "attention": cfg.attention.kind, "params": _param_count(params),
          "param_dtype": cfg.param_dtype, "activ_dtype": cfg.activ_dtype,
          "cache": type(eng.kv).__name__, "chunk_cap": eng.kv.chunk_cap,
          "slots": 4, "max_len": 4096, "chunk": eng.chunk,
          "prompts": list(SERVE["prompts"]), "new_tokens": FAMILY_SERVE_TOKENS,
          "wall_s": wall, "generated_tokens": st["generated_tokens"],
          "tok_per_s": st["generated_tokens"] / wall,
          "prefill_tokens": st["prefill_tokens"],
          "prefill_dispatches": st["prefill_dispatches"],
          "prefill_s": _dispatch_seconds(eng, "prefill_chunk_seconds"),
          "decode_dispatches": st["decode_dispatches"],
          "decode_s": _dispatch_seconds(eng, "decode_step_seconds"),
          "final_lengths": lengths.tolist(), "occupancy": occ,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    if int(bad) != 0:
        raise AssertionError(f"{int(bad)} non-finite logits")
    if (type(eng.kv).__name__ != "HybridWindowCache"
            or eng.kv.chunk_cap != cfg.local_window
            or int((lengths > cfg.local_window).sum()) < 2
            or occ["tokens_evicted"] <= 0):
        raise AssertionError(f"{type(eng.kv).__name__}: the ring did not "
                             f"wrap ({lengths.tolist()}, {occ})")
    if any(len(r.out) != FAMILY_SERVE_TOKENS or int(r.out.min()) < 0
           or int(r.out.max()) >= cfg.vocab for r in done):
        raise AssertionError("a stream is short or holds an out-of-vocab token")
    return eng


def phase_rgemma_train(torch, bsa):
    """recurrentgemma-9b's MRA-2 variant through ``train()`` at full width,
    the depth cut to RGEMMA_TRAIN_GROUPS whole (rglru, rglru, local) groups:
    three steps at seq 4096, batch 2, the preset's remat="full", the
    kernels' launches counted over exactly that run (the local layers:
    bsa_fwd twice a step, dq and dk/dv once), then a profiled step; one
    group more must run out of memory; one step of the preset's ``local``
    kind at the same depth (no kernel launched); then kernel against plain
    routes in fp32 on one batch (of RGEMMA_PARITY_BATCH sequences): loss,
    grad norm and every gradient leaf within 1e-4 at one group, two groups
    reported. The depth probe runs two steps: the AdamW moments are made
    in the first step's update, after its activations are freed."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.train import TrainConfig, train

    groups = RGEMMA_TRAIN_GROUPS
    cfg = _rgemma_mra(get_config(RGEMMA_ARCH, num_layers=3 * groups))
    launches, peak, state = phase_train_full_width(
        torch, bsa, RGEMMA_ARCH, "rgemma_train_full_width", cfg=cfg)
    if peak >= 80.0:
        raise AssertionError(f"recurrentgemma training peaked at {peak} GiB")
    phase_train_profile(torch, state, phase="rgemma_train_profile")
    shape = state[2]
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        train(cfg.replace(num_layers=3 * (groups + 1)), shape,
              TrainConfig(steps=2, seed=SEED, log_every=10**9), device=DEVICE)
        fits = True
    except torch.cuda.OutOfMemoryError:
        fits = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"phase": "rgemma_depth_cut", "groups": groups,
          "layers": 3 * groups, "full_depth": 38, "peak_gib": peak,
          "one_group_more_fits": fits, "probe_s": time.perf_counter() - t0})
    if fits:
        raise AssertionError(f"{groups + 1} groups fit too; the cut to "
                             f"{groups} is not the largest")
    local = get_config(RGEMMA_ARCH, num_layers=3 * groups)
    step, params = _one_step(torch, bsa, local, shape)
    del params
    torch.cuda.empty_cache()
    emit({"phase": "rgemma_local_step", "attention": local.attention.kind,
          "local_window": local.local_window, "layers": local.num_layers,
          **step})
    if any(step["launches"].values()) or not np.isfinite(step["loss"]):
        raise AssertionError(f"the local kind's step: {step}")
    pshape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                 global_batch=RGEMMA_PARITY_BATCH)
    result = {}
    for g in (1, 2):
        one = _rgemma_mra(get_config(RGEMMA_ARCH, num_layers=3 * g,
                                     activ_dtype="float32"))
        result[f"full_width_{g}_groups"] = _grad_parity(torch, bsa, one,
                                                        pshape)
        torch.cuda.empty_cache()
    emit({"phase": "rgemma_train_parity", "dtype": "float32",
          "batch": RGEMMA_PARITY_BATCH,
          "seq_len": pshape.seq_len, "tolerance": 1e-4,
          "held_at_1_group": ["loss_rel", "grad_norm_rel", "leaf_rel"],
          **result})
    f = result["full_width_1_groups"]
    if any(f[k] > 1e-4 for k in ("loss_rel", "grad_norm_rel", "leaf_rel")):
        raise AssertionError(f"recurrentgemma training differs: {f}")
    return launches


def phase_rgemma_self(torch, bsa):
    """recurrentgemma on the card against itself: the doubling RG-LRU scan
    against a sequential loop at the full-width shape (B = 2, T = 4096, W =
    4096; the reference test's 1e-4), both timed; the whole-prompt
    ``prefill`` then ``decode_step`` against stepwise decoding at one
    group (the reference test's tolerances, held in fp32, bf16 reported);
    the MRA-2 variant's whole-prompt ``prefill`` of a 4096-token prompt at
    one group on ``bsa_fwd`` (one launch) against the plain twin (last
    logits within 1e-4 of their largest magnitude, fp32); greedy streams
    of a one-group full-width fp32 engine with the window cut to 128 on the
    card against the same engine on the CPU (equal, or parting only at an
    fp32 near tie). Returns the prefill's bsa_fwd launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import recurrentgemma as RG
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request, Scheduler
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.cache import HybridWindowCache

    sh = RGEMMA_SCAN
    r = np.random.default_rng(SEED)
    shape = (sh["B"], sh["T"], sh["W"])
    a = torch.from_numpy((r.random(shape) * 0.9 + 0.05).astype(np.float32)
                         ).to(DEVICE)
    bx = torch.from_numpy(r.standard_normal(shape, np.float32)).to(DEVICE)

    def loop():
        h = torch.zeros_like(bx[:, 0])
        out = []
        for at, bt in zip(a.unbind(1), bx.unbind(1)):
            h = torch.addcmul(bt, at, h)
            out.append(h)
        return torch.stack(out, 1)

    with torch.no_grad():
        _, h = RG._rglru_scan(a, bx)
        want = loop()
        scan = {"shape": sh, "rel_err": float((h - want).abs().max()
                                              / want.abs().max()),
                "passes": int(np.ceil(np.log2(sh["T"]))),
                "scan_ms": time_ms(torch, lambda: RG._rglru_scan(a, bx), 5),
                "loop_ms": time_ms(torch, loop, 1)}
    del a, bx, h, want

    def cache(cfg, B, S):
        return HybridWindowCache(cfg, RG, B, S, device=DEVICE).tree

    cont = {}
    for adt in ("float32", "bfloat16"):
        cfg = get_config(RGEMMA_ARCH, num_layers=3, activ_dtype=adt)
        params = init_params(cfg, seed=SEED, device=DEVICE)
        B, S = 2, 160
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            1, cfg.vocab, (B, S)).astype(np.int32)).to(DEVICE)
        with torch.no_grad():
            lp, cp = RG.prefill(params, cfg, {"tokens": toks}, cache(cfg, B, S))
            cd = cache(cfg, B, S)
            for t in range(S):
                ld, cd = RG.decode_step(params, cfg, cd, toks[:, t])
        logit_ok = torch.allclose(lp.float(), ld.float(), atol=0.05, rtol=0.05)
        cont[adt] = {"logits_max_abs": float((lp.float() - ld.float())
                                             .abs().max()),
                     "h_max_abs": float((cp["h"] - cd["h"]).abs().max()),
                     "within_reference_tolerances": bool(logit_ok)}
        del params, cp, cd
    torch.cuda.empty_cache()

    cfg = _rgemma_mra(get_config(RGEMMA_ARCH, num_layers=3,
                                 activ_dtype="float32"))
    params = init_params(cfg, seed=SEED, device=DEVICE)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (2, RGEMMA_PREFILL)).astype(np.int32)).to(DEVICE)
    runs = {}
    for plain in (False, True):
        _reset_bsa(bsa)
        with (_plain_twins(bsa) if plain else contextlib.nullcontext()), \
                torch.no_grad():
            logits, _ = RG.prefill(params, cfg, {"tokens": toks},
                                   cache(cfg, 2, RGEMMA_PREFILL))
        runs[plain] = (logits.float(), _bsa_launches(bsa))
    prefill = {"prompt": RGEMMA_PREFILL, "layers": 3,
               "launches": runs[False][1],
               "logits_rel": float((runs[False][0] - runs[True][0]).abs().max()
                                   / runs[True][0].abs().max())}
    del params, runs
    torch.cuda.empty_cache()

    cfg = get_config(RGEMMA_ARCH, num_layers=3, activ_dtype="float32",
                     local_window=RGEMMA_STREAMS["window"])
    card = init_params(cfg, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=4, max_len=4096, chunk=128)
    streams = {}
    (p_sample, p_sched), gaps = _top2_recorder(torch, engine_mod, Scheduler,
                                               cfg.vocab)
    for where, params in (("cpu", _on(card, "cpu")), (DEVICE, card)):
        reqs = _requests(Request, RGEMMA_STREAMS["prompts"],
                         RGEMMA_STREAMS["new_tokens"], cfg.vocab)
        with (p_sample if where == DEVICE else contextlib.nullcontext()), \
                (p_sched if where == DEVICE else contextlib.nullcontext()):
            done = Engine(cfg, params, ecfg, device=where).run(reqs)
        streams[where] = {len(q.prompt): np.asarray(q.out) for q in done}
        del params
    parts = {}
    for n, want in streams["cpu"].items():
        got = streams[DEVICE][n]
        diff = np.flatnonzero(got != want)
        if len(diff):
            j = int(diff[0])
            gap, top = (float(x) for x in gaps[n][j])
            parts[n] = {"token": j, "gap": gap, "top": top,
                        "near_tie": gap <= 1e-4 * max(abs(top), 1.0)}
    emit({"phase": "rgemma_self", "arch": RGEMMA_ARCH, "scan": scan,
          "prefill_vs_stepwise_1_group": cont,
          "mra2_prefill_kernel_vs_plain": prefill,
          "streams_card_vs_cpu": {"layers": 3, "activ_dtype": "float32",
                                  "local_window": RGEMMA_STREAMS["window"],
                                  "prompts": list(RGEMMA_STREAMS["prompts"]),
                                  "new_tokens": RGEMMA_STREAMS["new_tokens"],
                                  "equal": not parts, "parts": parts}})
    if scan["rel_err"] > 1e-4:
        raise AssertionError(f"the RG-LRU scan vs its loop: {scan}")
    if not cont["float32"]["within_reference_tolerances"]:
        raise AssertionError(f"prefill vs stepwise decode: {cont}")
    if (prefill["launches"] != {"bsa_fwd": 1, "bsa_bwd_dq": 0,
                                "bsa_bwd_dkv": 0}
            or prefill["logits_rel"] > 1e-4):
        raise AssertionError(f"the MRA-2 whole-prompt prefill: {prefill}")
    if any(not p["near_tie"] for p in parts.values()):
        raise AssertionError(f"card and CPU streams part: {parts}")
    return prefill["launches"]["bsa_fwd"]


# --------------------------------------------------------------------------- #
# phases 35-37: a (data, model) = (2, 2) mesh of four ranks on the one card
# --------------------------------------------------------------------------- #
MESH_SHAPE = (2, 2)
MESH_PARITY_LAYERS = 2  # the fp32 step and engine held to one device
MESH_TRAIN_LAYERS = 2  # the bf16 step's depth (of 28: cut for time)
MESH_TRAIN_STEPS = 2  # the second reads what the first ZeRO-1 update wrote
MESH_NEW_TOKENS = 8  # a mesh engine request's new tokens (phase 4: 144)
# the one of phase 4's prompts served by the deep bf16 mesh engines (qwen3,
# granite-moe, rwkv6, recurrentgemma; all four in the fp32 parity engines)
MESH_DEEP_PROMPT = 2
MESH_MOE = dict(B=2, S=2048)  # granite-moe's one-layer tokens
MESH_RWKV_TRAIN_LAYERS = 2  # rwkv6's bf16 step on four ranks (of 32)
MESH_RWKV_SERVE_LAYERS = 32  # rwkv6's bf16 mesh engine: the whole depth
MESH_RGEMMA_GROUPS = 1  # recurrentgemma's fp32 parity and engine
MESH_RGEMMA_SERVE_GROUPS = 1  # its bf16 mesh engine, reported (of 12 + 2)
MESH_TIMEOUT = 900


def _mesh_shapes(torch, bsa, chunk_attn):
    """(context, record): while the context is open, every block-sparse
    and chunk kernel launch records its operands' local shapes (counts by
    (kernel, q shape, k shape, dtype))."""
    record = {}
    check, launch = bsa._check_qkv, chunk_attn._launch

    def note(key):
        record[key] = record.get(key, 0) + 1

    def check_qkv(q, k, v, block_size):
        note(("bsa", tuple(q.shape), tuple(k.shape), str(q.dtype)))
        return check(q, k, v, block_size)

    def launch_chunk(pre, k_cache, *a, **kw):
        note(("chunk_attn", tuple(pre.qg.shape), tuple(k_cache.shape),
              str(k_cache.dtype)))
        return launch(pre, k_cache, *a, **kw)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(bsa, "_check_qkv", check_qkv))
    stack.enter_context(mock.patch.object(chunk_attn, "_launch",
                                          launch_chunk))
    return stack, record


def _shape_list(record):
    return [{"kernel": k[0], "q": list(k[1]), "kv": list(k[2]),
             "dtype": k[3], "calls": n} for k, n in sorted(record.items())]


def _mesh_probe(torch, mesh):
    """Each collective ``collectives.py`` uses, on CUDA tensors, against
    its value computed from the ranks' known inputs."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C

    dev, rank, M = mesh.device, dist.get_rank(), MESH_SHAPE[1]
    d, m = mesh.index("data"), mesh.index("model")

    def x_of(r):
        return torch.arange(12.0, device=dev).reshape(4, 3) + 100 * r

    model_ranks = [d * M + j for j in range(M)]
    data_ranks = [i * M + m for i in range(MESH_SHAPE[0])]
    ok = {}
    got = C.all_reduce(x_of(rank), mesh, "model")
    ok["all_reduce_sum"] = bool(torch.equal(got, sum(x_of(r)
                                                     for r in model_ranks)))
    got = C.all_reduce(x_of(rank), mesh, "data", "max")
    ok["all_reduce_max"] = bool(torch.equal(got, x_of(max(data_ranks))))
    got = C.all_gather(x_of(rank), mesh, "data", 0)
    ok["all_gather"] = bool(torch.equal(got, torch.cat([x_of(r) for r in
                                                        data_ranks])))
    got = C.all_to_all(x_of(rank), mesh, "model", 0, 1)
    want = torch.cat([x_of(r).chunk(M, 0)[m] for r in model_ranks], 1)
    ok["all_to_all"] = bool(torch.equal(got, want))
    y = x_of(rank).requires_grad_()
    (C.copy_to(y, mesh, "model") * (rank + 1)).sum().backward()
    ok["copy_to_backward"] = bool(torch.equal(
        y.grad, torch.full_like(y, float(sum(r + 1 for r in model_ranks)))))
    snap = C.STATS.snapshot()
    return {"backend": mesh.backend, "device": str(dev), "checks": ok,
            "staged_ops": snap["staged_ops"], "ops": snap["ops"]}


def _qwen3_small():
    from repro_torch.configs import get_config

    return get_config("qwen3-1.7b", num_layers=MESH_PARITY_LAYERS,
                      activ_dtype="float32")


def _granite_small():
    """granite-moe at 2 full-width layers, fp32, with the no-drop capacity
    of ``_moe_cfg``: the mesh and one device serve the same function."""
    return _moe_cfg("psum").replace(num_layers=MESH_PARITY_LAYERS)


def _rwkv_small():
    from repro_torch.configs import get_config

    return get_config(RWKV_ARCH, num_layers=MESH_PARITY_LAYERS,
                      activ_dtype="float32")


def _rgemma_small(mra, window=None):
    """recurrentgemma at MESH_RGEMMA_GROUPS full-width groups, fp32: the
    preset's ``local`` kind, or (``mra``) its MRA-2 variant; ``window``
    cuts the local window (phase 34's streams)."""
    from repro_torch.configs import get_config

    cut = {} if window is None else {"local_window": window}
    cfg = get_config(RGEMMA_ARCH, num_layers=3 * MESH_RGEMMA_GROUPS,
                     activ_dtype="float32", **cut)
    return _rgemma_mra(cfg) if mra else cfg


def _rgemma_streams_cfg():
    """The fp32 engine of phase 39's stream parity: one group, the window
    cut to phase 34's 128 so its prompts wrap the ring."""
    return _rgemma_small(False, RGEMMA_STREAMS["window"])


def _mesh_grad_parity(torch, bsa, mesh, ref_path, cfg=None, plain=False,
                      keep=False):
    """``cfg`` (default: qwen3-1.7b at full width, 2 layers, fp32): one
    batch's loss, global grad norm and gradient blocks (averaged over the
    data axis) on the mesh, against the one-device values in ``ref_path``;
    ``plain`` substitutes the plain twins for the kernels, ``keep`` also
    returns the rank's local gradients (before the data mean) on the
    host; with ``ref_path`` None only those (and the launches)."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import make_batch
    from repro_torch.distributed import mesh_utils
    from repro_torch.distributed.sharding import (
        batch_pspec,
        local_block,
        param_placements,
    )
    from repro_torch.kernels import chunk_attn
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.models.registry import get_model
    from repro_torch.optim.adamw import global_norm, tree_leaves_pspec, zero_plan
    from repro_torch.train.loop import data_mean

    cfg = cfg or _qwen3_small()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    params = init_params(cfg, seed=SEED, device=mesh.device, mesh=mesh)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: local_block(torch.from_numpy(v), batch_pspec(mesh, v.ndim),
                            mesh).to(mesh.device)
             for k, v in make_batch(cfg, shape, step=0, seed=SEED).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_bsa(bsa)
    t0 = time.perf_counter()
    ctx, shapes = _mesh_shapes(torch, bsa, chunk_attn)
    with ctx, mesh_utils.use_mesh(mesh), (
            _plain_twins(bsa) if plain else contextlib.nullcontext()):
        loss, _ = get_model(cfg).loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    launches = _bsa_launches(bsa)
    if plain:
        _check_route(bsa, plain, "mesh gradient")
    local = ([g.cpu() for g in grads], float(loss.detach())) if keep else None
    if ref_path is None:
        return {"launches": launches, "grad_s": grad_s}, local
    placements = param_placements(cfg, mesh)
    plan = zero_plan(params, placements, mesh)
    # from here on the rank holds its gradients and one reference leaf
    del params, leaves, batch
    grads = data_mean(grads, mesh)
    loss = float(data_mean([loss.detach()], mesh)[0])
    gnorm = float(global_norm(grads, plan))
    ref = torch.load(ref_path, mmap=True)

    def amax(t):  # max |entry| without a tensor of |entries|
        return float(torch.maximum(t.max(), t.min().neg()))

    worst_abs = worst_rel = 0.0
    for g, w, ps in zip(grads, ref["grads"], tree_leaves_pspec(placements)):
        w = local_block(w, ps, mesh).to(g.device, copy=True)
        w_max = amax(w)
        err = amax(w.sub_(g))
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(w_max, 1e-30))
    out = {"layers": cfg.num_layers, "loss": loss, "loss_ref": ref["loss"],
           "loss_rel": abs(loss - ref["loss"]) / abs(ref["loss"]),
           "grad_norm": gnorm, "grad_norm_ref": ref["grad_norm"],
           "grad_norm_rel": abs(gnorm - ref["grad_norm"]) / ref["grad_norm"],
           "leaf_max_abs": worst_abs, "leaf_rel": worst_rel,
           "launches": launches, "launch_shapes": _shape_list(shapes),
           "grad_s": grad_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return (out, local) if keep else out


def _mesh_route_parity(torch, kernel, plain, device):
    """The rank's local gradients on the kernels against the plain twins
    (``_mesh_grad_parity(..., keep=True)``'s, on the host): loss, the
    rank's gradient norm and the worst leaf's max |difference| over its
    largest |entry|, one pair of leaves at a time on ``device``."""
    (gk, lk), (gp, lp) = kernel, plain
    sq, rels = [0.0, 0.0], []
    for a, b in zip(gk, gp):
        a, b = a.to(device, copy=True), b.to(device)
        for i, g in enumerate((a, b)):
            sq[i] += float(torch.linalg.vector_norm(g, dtype=torch.float64)
                           ** 2)
        b_max = float(b.abs().max().clamp_min(1e-30))
        rels.append(float(a.sub_(b).abs_().max()) / b_max)
        del a, b
    norm = [v ** 0.5 for v in sq]
    return {"loss_kernel": lk, "loss_plain": lp, "loss_rel": _rel(lk, lp),
            "grad_norm_rel": _rel(norm[0], norm[1]), "leaf_rel": max(rels)}


def _moe_weights(torch, cfg, device):
    """One granite-moe layer's experts and an input batch, drawn from the
    seed on ``device`` (the same on every rank and in the parent)."""
    from repro_torch.models.moe import moe_specs

    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    w = {}
    for key, spec in sorted(moe_specs(cfg).items()):
        std = spec.scale or spec.shape[-2] ** -0.5
        w[key] = torch.randn(spec.shape, generator=g, device=device) * std
    x = torch.randn((MESH_MOE["B"], MESH_MOE["S"], cfg.d_model), generator=g,
                    device=device)
    return w, x


def _moe_cfg(dispatch):
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH, activ_dtype="float32", moe_dispatch=dispatch)
    # capacity E / top_k of the even share: no assignment drops at any token
    # count, so the mesh (capacity from each data rank's tokens, as in the
    # reference) and one device compute the same function
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def _moe_grads(torch, cfg, w, x):
    from repro_torch.models.moe import moe_block

    leaves = [x] + [w[k] for k in sorted(w)]
    for t in leaves:
        t.requires_grad_(True)
    out, aux = moe_block(x, w, cfg)
    grads = torch.autograd.grad((out.float() ** 2).sum(), leaves)
    return out.detach(), grads


def _mesh_moe(torch, mesh, ref_path):
    """granite-moe's layer at full width on the mesh (20 of 40 experts a
    model rank): forward and backward under psum and a2a against the
    one-device values in ``ref_path``."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import mesh_utils
    from repro_torch.distributed.sharding import (
        local_block,
        logical_to_pspec,
        shard_tree,
    )
    from repro_torch.models.moe import moe_specs

    ref = torch.load(ref_path, mmap=True)
    out = {}
    for dispatch in ("psum", "a2a"):
        cfg = _moe_cfg(dispatch)
        w, x = _moe_weights(torch, cfg, mesh.device)
        wl = shard_tree(w, moe_specs(cfg), mesh)
        xl = local_block(x, ("data", None, None), mesh).clone()
        C.STATS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mesh_utils.use_mesh(mesh):
            o, grads = _moe_grads(torch, cfg, wl, xl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        comm = C.STATS.snapshot()
        r = ref[dispatch]
        errs, rels = {}, {}

        def held(name, got, want):
            err = float((got - want).abs().max())
            errs[name] = err
            rels[name] = err / max(float(want.abs().max()), 1e-30)

        rows = ("data", None, None)
        held("out", o, local_block(r["out"], rows, mesh).to(o.device))
        held("dx", grads[0], local_block(r["grads"][0], rows, mesh).to(
            o.device))
        specs = moe_specs(cfg)
        for key, g, rg in zip(sorted(wl), grads[1:], r["grads"][1:]):
            s = specs[key]
            g = C.all_reduce(g, mesh, "data")  # the data ranks' shares
            held(f"d{key}", g, local_block(
                rg, logical_to_pspec(s.shape, s.axes, mesh), mesh).to(
                    g.device))
        out[dispatch] = {"max_abs_err": errs, "rel_err": rels, "wall_s": wall,
                         "experts_local": int(wl["wi"].shape[0]),
                         "comm": comm}
    return out


def _mesh_engine(torch, chunk_attn, mesh, cfg, new_tokens, pick=None,
                 prompts=SERVE["prompts"]):
    """Phase 4's requests (or ``prompts``; ``new_tokens`` each; only the
    ``pick``-th when given) through ``Engine`` on the mesh: streams,
    launches, the local shapes of every launch, wall seconds and the
    collectives' bytes and seconds."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    params = init_params(cfg, seed=SEED, device=mesh.device, mesh=mesh)
    eng = Engine(cfg, params, EngineConfig(slots=4, max_len=4096, chunk=128,
                                           mesh=mesh), device=DEVICE)
    reqs = _requests(Request, prompts, new_tokens, cfg.vocab)
    if pick is not None:
        reqs = [reqs[pick]]
    ctx, shapes = _mesh_shapes(torch, bsa, chunk_attn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    C.STATS.reset()
    with ctx:
        _reset_chunk(chunk_attn)
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, upper = _chunk_launches(chunk_attn)
    st = eng.stats
    comm = C.STATS.snapshot()
    return {"layers": cfg.num_layers, "activ_dtype": cfg.activ_dtype,
            "streams": {len(r.prompt): np.asarray(r.out).tolist()
                        for r in done},
            "wall_s": wall, "generated_tokens": st["generated_tokens"],
            "tok_per_s": st["generated_tokens"] / wall,
            "dispatches": st["prefill_dispatches"] + st["decode_dispatches"],
            "kernel_launches": launches, "upper_launches": upper,
            "launch_shapes": _shape_list(shapes),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "comm_s": sum(v["seconds"] for v in comm["ops"].values()),
            "staging_s": sum(v["staging_seconds"]
                             for v in comm["ops"].values()),
            "comm": comm}


def _bits_checksum(torch, t, chunk=1 << 24) -> int:
    """A tensor's 32-bit words (its bytes when they do not pack into
    words), each times its position + 1, summed in wrapping int64 chunks:
    equal blocks give equal sums, and a changed or moved entry changes
    them (a plain sum would miss a permutation)."""
    t = t.detach().contiguous().view(-1)
    w = (t.view(torch.int32) if (t.numel() * t.element_size()) % 4 == 0
         else t.view(torch.uint8))
    total = 0
    for i in range(0, w.numel(), chunk):
        c = w[i:i + chunk].to(torch.int64)
        total += int((c * torch.arange(i + 1, i + 1 + c.numel(),
                                       device=c.device)).sum())
    return total


def _mesh_train(torch, bsa, chunk_attn, mesh, cfg=None,
                n_steps=MESH_TRAIN_STEPS):
    """``cfg``'s ``train()`` on the mesh (default: qwen3-1.7b at
    MESH_TRAIN_LAYERS layers, bf16 activations, remat="full"), seq 4096,
    batch 2 (one row a data rank), ``n_steps`` steps: metrics, launches
    and their local shapes, peak memory, the collectives' bytes, seconds
    and host staging seconds per step, and a bit checksum of every
    parameter block after the last update (``_bits_checksum``)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import TrainConfig, train

    cfg = cfg or get_config("qwen3-1.7b", num_layers=MESH_TRAIN_LAYERS)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    tc = TrainConfig(steps=n_steps, seed=SEED, log_every=10**9)
    steps = []
    ctx, shapes = _mesh_shapes(torch, bsa, chunk_attn)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C.STATS.reset()
    _reset_bsa(bsa)
    with ctx:
        t0 = time.perf_counter()
        params, _, _ = train(
            cfg, shape, tc, device=DEVICE, mesh=mesh,
            on_metrics=lambda s, m: steps.append(
                {"step": s, "loss": m["loss"], "grad_norm": m["grad_norm"],
                 "seconds": m["step_time_s"],
                 "tokens_per_s": m["tokens_per_s"]}))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    comm = C.STATS.snapshot()
    checksums = [_bits_checksum(torch, p) for p in tree_leaves(params)]
    del params
    free, total = torch.cuda.mem_get_info()
    return {"layers": cfg.num_layers, "remat": cfg.remat,
            "activ_dtype": cfg.activ_dtype, "param_dtype": cfg.param_dtype,
            "seq_len": shape.seq_len, "batch": shape.global_batch,
            "steps": steps, "wall_s": wall,
            "kernel_launches": _bsa_launches(bsa),
            "launch_shapes": _shape_list(shapes),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            "card_used_gib_after": (total - free) / 2**30,
            "param_checksums": checksums,
            "comm_bytes_per_step": {k: v["bytes"] / n_steps
                                    for k, v in comm["ops"].items()},
            "comm_s": sum(v["seconds"] for v in comm["ops"].values()),
            "staging_s": sum(v["staging_seconds"]
                             for v in comm["ops"].values()),
            "comm": comm}


def mesh_rank(rank, job):
    """One rank of phases 35-37 (``launch.mesh.spawn``; every rank on
    cuda:0, gloo): the collective probe, qwen3-1.7b's fp32 gradients and
    engine at 2 layers, granite-moe's MoE layer, qwen3-1.7b's bf16
    ``train()`` and engine at full depth, granite-moe's engine."""
    import torch

    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels import chunk_attn
    from repro_torch.launch.mesh import make_local_mesh

    from repro_torch.configs import get_config

    # host clock (shared by the ranks and the parent): the spawn's start-up
    entered = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_local_mesh(*MESH_SHAPE)
    out = {"rank": rank, "index": {a: mesh.index(a) for a in mesh.shape},
           "entered": entered, "mesh_up": time.time()}
    _timed(torch, out, "probe", lambda: _mesh_probe(torch, mesh))
    _timed(torch, out, "grad_parity", lambda: _mesh_grad_parity(
        torch, bsa, mesh, job["qwen3"]))
    _timed(torch, out, "engine_fp32", lambda: _mesh_engine(
        torch, chunk_attn, mesh, _qwen3_small(), MESH_NEW_TOKENS))
    _timed(torch, out, "moe", lambda: _mesh_moe(torch, mesh, job["moe"]))
    _timed(torch, out, "train", lambda: _mesh_train(
        torch, bsa, chunk_attn, mesh))
    _timed(torch, out, "engine", lambda: _mesh_engine(
        torch, chunk_attn, mesh, get_config("qwen3-1.7b"), MESH_NEW_TOKENS,
        MESH_DEEP_PROMPT))
    _timed(torch, out, "granite_engine", lambda: _mesh_engine(
        torch, chunk_attn, mesh,
        get_config(MOE_ARCH, num_layers=MOE_SERVE_LAYERS), MESH_NEW_TOKENS,
        MESH_DEEP_PROMPT))
    _timed(torch, out, "granite_engine_fp32", lambda: _mesh_engine(
        torch, chunk_attn, mesh, _granite_small(), MESH_NEW_TOKENS))
    # phases 38-39 hold the most bytes of a rank: segments that grow in
    # place keep the four ranks' caches from fragmenting the card
    with _expandable_segments(torch):
        _timed(torch, out, "rwkv", lambda: _mesh_rwkv(
            torch, bsa, chunk_attn, mesh, job))
        _timed(torch, out, "rgemma", lambda: _mesh_rgemma(
            torch, bsa, chunk_attn, mesh, job))
    out["left"] = time.time()
    return out


def _timed(torch, out, key, fn):
    """``out[key] = fn()``, its wall seconds in ``out["seconds"]``; the
    cache emptied after."""
    t0 = time.perf_counter()
    out[key] = fn()
    torch.cuda.synchronize()
    out.setdefault("seconds", {})[key] = time.perf_counter() - t0
    torch.cuda.empty_cache()


def _mesh_rwkv(torch, bsa, chunk_attn, mesh, job):
    """Phase 38 on one rank: rwkv6-7b at full width, its heads and d_ff
    split over "model" (``models/rwkv6.py``): fp32 gradients at 2 layers
    against one device, the 2-layer fp32 mesh engine, one bf16 ``train()``
    step at MESH_RWKV_TRAIN_LAYERS layers and the bf16 mesh engine at
    MESH_RWKV_SERVE_LAYERS."""
    from repro_torch.configs import get_config

    out = {}
    _timed(torch, out, "parity", lambda: _mesh_grad_parity(
        torch, bsa, mesh, job["rwkv"], _rwkv_small()))
    _timed(torch, out, "engine_fp32", lambda: _mesh_engine(
        torch, chunk_attn, mesh, _rwkv_small(), MESH_NEW_TOKENS))
    _timed(torch, out, "train", lambda: _mesh_train(
        torch, bsa, chunk_attn, mesh,
        get_config(RWKV_ARCH, num_layers=MESH_RWKV_TRAIN_LAYERS), 1))
    _timed(torch, out, "engine", lambda: _mesh_engine(
        torch, chunk_attn, mesh,
        get_config(RWKV_ARCH, num_layers=MESH_RWKV_SERVE_LAYERS),
        MESH_NEW_TOKENS, MESH_DEEP_PROMPT))
    return out


def _mesh_rgemma(torch, bsa, chunk_attn, mesh, job):
    """Phase 39 on one rank: recurrentgemma-9b at full width (the RG-LRU
    whole on every rank, the MLP and vocab split, the one KV head's
    attention on the rank's rows): fp32 gradients at MESH_RGEMMA_GROUPS
    groups against one device for the ``local`` kind and the MRA-2
    variant, the latter on the block-sparse kernels (launches counted) and
    on their plain twins; the fp32 mesh engine at that depth on prompts
    that wrap the ring; the bf16 mesh engine at MESH_RGEMMA_SERVE_GROUPS
    groups. (A bf16 ``train()`` step of one group does not fit four ranks
    on one H100 80GB: 16.5 GiB a rank were held when the vocab-parallel
    loss asked for 1.95 more.)"""
    from repro_torch.configs import get_config

    out, local = {}, {}
    _timed(torch, out, "parity_local", lambda: _mesh_grad_parity(
        torch, bsa, mesh, job["rgemma_local"], _rgemma_small(False)))
    for name, ref in (("parity_mra", job["rgemma_mra"]),
                      ("parity_mra_plain", None)):
        _timed(torch, out, name, lambda: _mesh_grad_parity(
            torch, bsa, mesh, ref, _rgemma_small(True), plain=ref is None,
            keep=True))
        out[name], local[name] = out[name]
    _timed(torch, out, "mra_kernel_vs_plain", lambda: _mesh_route_parity(
        torch, local["parity_mra"], local["parity_mra_plain"], mesh.device))
    del local
    _timed(torch, out, "engine_fp32", lambda: _mesh_engine(
        torch, chunk_attn, mesh, _rgemma_streams_cfg(), MESH_NEW_TOKENS,
        prompts=RGEMMA_STREAMS["prompts"]))
    _timed(torch, out, "engine", lambda: _mesh_engine(
        torch, chunk_attn, mesh,
        get_config(RGEMMA_ARCH, num_layers=3 * MESH_RGEMMA_SERVE_GROUPS),
        MESH_NEW_TOKENS, MESH_DEEP_PROMPT))
    return out


def _first_part(got, want):
    """{prompt length: index of the first token where ``got`` leaves
    ``want`` (None: equal over ``got``'s length)}."""
    out = {}
    for n, g in got.items():
        w = np.asarray(want[n])[:len(g)]
        diff = np.flatnonzero(np.asarray(g) != w)
        out[n] = int(diff[0]) if len(diff) else None
    return out


def _mesh_references(torch, bsa, job):
    """The one-device references of phases 35-39: the fp32 gradients of
    qwen3-1.7b and rwkv6-7b at 2 layers and of recurrentgemma-9b's two
    kinds at MESH_RGEMMA_GROUPS groups, and granite-moe's MoE layer (saved
    to ``job``'s files for the ranks), and the small fp32 engines'
    streams (returned)."""
    from repro_torch.configs import SHAPES
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = _qwen3_small()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN["seq"],
                                global_batch=TRAIN["batch"])
    for name, gcfg in (("qwen3", cfg), ("rwkv", _rwkv_small()),
                       ("rgemma_local", _rgemma_small(False)),
                       ("rgemma_mra", _rgemma_small(True))):
        loss, grads, _ = _grads(torch, bsa, gcfg, shape, plain=False)
        gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        torch.save({"loss": loss, "grad_norm": gnorm,
                    "grads": [g.cpu() for g in grads]}, job[name])
        del grads
        torch.cuda.empty_cache()
    streams = {}
    for name, scfg, prompts in (
            ("qwen3", cfg, SERVE["prompts"]),
            ("granite", _granite_small(), SERVE["prompts"]),
            ("rwkv", _rwkv_small(), SERVE["prompts"]),
            ("rgemma", _rgemma_streams_cfg(), RGEMMA_STREAMS["prompts"])):
        params = init_params(scfg, seed=SEED, device=DEVICE)
        eng = Engine(scfg, params, EngineConfig(slots=4, max_len=4096,
                                                chunk=128), device=DEVICE)
        done = eng.run(_requests(Request, prompts, MESH_NEW_TOKENS,
                                 scfg.vocab))
        streams[name] = {len(r.prompt): np.asarray(r.out) for r in done}
        del eng, params
    moe_ref = {}
    for dispatch in ("psum", "a2a"):
        mcfg = _moe_cfg(dispatch)
        w, x = _moe_weights(torch, mcfg, DEVICE)
        o, g = _moe_grads(torch, mcfg, w, x)
        moe_ref[dispatch] = {"out": o.cpu(), "grads": [t.cpu() for t in g]}
        del w, x, o, g
    torch.save(moe_ref, job["moe"])
    del moe_ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return streams


def phase_mesh(torch, bsa, chunk_attn, base, moe_base, rwkv_base):
    """Phases 35-39: the one-device references first (the fp32 gradients
    and engine streams of qwen3-1.7b, rwkv6-7b and recurrentgemma-9b at
    their small depths, granite-moe's MoE layer), then four ranks spawned
    on the card, a (2, 2) mesh over gloo. Every rank's failure fails the
    phase; nothing falls back to one rank or to the CPU."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        job = {name: f"{tmp}/{name}.pt" for name in
               ("qwen3", "moe", "rwkv", "rgemma_local", "rgemma_mra")}
        t0 = time.perf_counter()
        small_streams = _mesh_references(torch, bsa, job)
        refs_s = time.perf_counter() - t0
        t0, spawned = time.perf_counter(), time.time()
        ranks = spawn(mesh_rank, MESH_SHAPE[0] * MESH_SHAPE[1], job,
                      device=DEVICE, timeout=MESH_TIMEOUT)
        wall = time.perf_counter() - t0
    r0 = ranks[0]
    emit({"phase": "mesh_probe", "mesh": dict(zip(("data", "model"),
                                                  MESH_SHAPE)),
          "ranks": len(ranks), "ranks_wall_s": wall, "references_s": refs_s,
          # per rank: spawn -> fn entered -> mesh up, each part, fn left
          "start_s_by_rank": {r["rank"]: r["entered"] - spawned
                              for r in ranks},
          "mesh_up_s_by_rank": {r["rank"]: r["mesh_up"] - r["entered"]
                                for r in ranks},
          "seconds_by_rank": {r["rank"]: r["seconds"] for r in ranks},
          "returned_s_by_rank": {r["rank"]: spawned + wall - r["left"]
                                 for r in ranks},
          **{k: r0["probe"][k] for k in ("backend", "device", "staged_ops")},
          "checks": {r["rank"]: r["probe"]["checks"] for r in ranks}})
    gp = {r["rank"]: r["grad_parity"] for r in ranks}
    emit({"phase": "mesh_qwen3_parity", "dtype": "float32",
          "layers": MESH_PARITY_LAYERS, "by_rank": gp})
    e32 = {r["rank"]: _first_part(r["engine_fp32"]["streams"],
                                  small_streams["qwen3"]) for r in ranks}
    g32 = {r["rank"]: _first_part(r["granite_engine_fp32"]["streams"],
                                  small_streams["granite"]) for r in ranks}
    emit({"phase": "mesh_qwen3_engine_parity", "dtype": "float32",
          "layers": MESH_PARITY_LAYERS, "new_tokens": MESH_NEW_TOKENS,
          "first_part_by_rank": e32,
          "by_rank": {r["rank"]: {k: v for k, v in r["engine_fp32"].items()
                                  if k not in ("streams", "comm")}
                      for r in ranks}})
    tr = {r["rank"]: {k: v for k, v in r["train"].items()
                      if k not in ("comm", "param_checksums")}
          for r in ranks}
    by_rank = {r["rank"]: r for r in ranks}
    # each rank's peer: data index 0, the same model index (rank d * M + m)
    peers = {r["rank"]: by_rank[r["index"]["model"]] for r in ranks}
    blocks_agree = {k: r["train"]["param_checksums"]
                    == peers[k]["train"]["param_checksums"]
                    for k, r in by_rank.items()}
    train_wall = r0["train"]["wall_s"]
    emit({"phase": "mesh_qwen3_train", "by_rank": tr,
          "card_peak_gib_sum": sum(t["peak_gib"] for t in tr.values()),
          "card_reserved_gib_sum": sum(t["reserved_gib"] for t in tr.values()),
          "staging_share": {k: t["staging_s"] / t["wall_s"]
                            for k, t in tr.items()},
          "comm_share": {k: t["comm_s"] / t["wall_s"] for k, t in tr.items()},
          "param_leaves": len(r0["train"]["param_checksums"]),
          "param_blocks_agree_with_data_peer": blocks_agree,
          "train_wall_s_rank0": train_wall})
    full = {r["rank"]: _first_part(r["engine"]["streams"], base["streams"])
            for r in ranks}
    emit({"phase": "mesh_qwen3_engine", "layers": r0["engine"]["layers"],
          "new_tokens": MESH_NEW_TOKENS, "first_part_vs_phase4": full,
          "streams_equal_across_ranks": all(
              r["engine"]["streams"] == r0["engine"]["streams"]
              for r in ranks),
          "by_rank": {r["rank"]: {k: v for k, v in r["engine"].items()
                                  if k not in ("streams", "comm")}
                      for r in ranks}})
    emit({"phase": "mesh_granite_moe", "dtype": "float32", "tokens":
          MESH_MOE, "by_rank": {r["rank"]: r["moe"] for r in ranks}})
    gran = {r["rank"]: _first_part(r["granite_engine"]["streams"],
                                   moe_base["streams"]) for r in ranks}
    emit({"phase": "mesh_granite_engine",
          "layers": r0["granite_engine"]["layers"],
          "new_tokens": MESH_NEW_TOKENS, "first_part_vs_phase16": gran,
          "fp32_no_drop_layers": MESH_PARITY_LAYERS,
          "fp32_no_drop_first_part_by_rank": g32,
          "by_rank": {r["rank"]: {k: v for k, v in
                                  r["granite_engine"].items()
                                  if k not in ("streams", "comm")}
                      for r in ranks}})
    # holds
    # NCCL with a card a rank, gloo when the ranks share the card
    backend = ("nccl" if torch.cuda.device_count() >= len(ranks)
               else "gloo")
    if r0["probe"]["backend"] != backend or not all(
            all(r["probe"]["checks"].values()) for r in ranks):
        raise AssertionError(f"collective probe: {[r['probe'] for r in ranks]}")
    L2 = MESH_PARITY_LAYERS  # forward twice a layer: the preset's remat
    for k, g in gp.items():
        if (g["loss_rel"] > 1e-4 or g["grad_norm_rel"] > 1e-4
                or g["leaf_max_abs"] > 5e-3):
            raise AssertionError(f"rank {k}: mesh gradients vs one device {g}")
        if g["launches"] != {"bsa_fwd": 2 * L2, "bsa_bwd_dq": L2,
                             "bsa_bwd_dkv": L2}:
            raise AssertionError(f"rank {k}: launches {g['launches']}")
    for name, parts in (("qwen3", e32), ("granite", g32)):
        if any(p is not None for r in parts.values() for p in r.values()):
            raise AssertionError(f"fp32 mesh {name} engine streams part: "
                                 f"{parts}")
    L = MESH_TRAIN_LAYERS
    want = {"bsa_fwd": 2 * L * MESH_TRAIN_STEPS,
            "bsa_bwd_dq": L * MESH_TRAIN_STEPS,
            "bsa_bwd_dkv": L * MESH_TRAIN_STEPS}
    hkv_local = 8 // MESH_SHAPE[1]
    for k, t in tr.items():
        if t["kernel_launches"] != want:
            raise AssertionError(f"rank {k}: train launches {t} != {want}")
        if not all(s["kv"][0] == hkv_local * TRAIN["batch"] // MESH_SHAPE[0]
                   for s in t["launch_shapes"]):
            raise AssertionError(f"rank {k}: launch shapes {t}")
        if not all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                   for s in t["steps"]):
            raise AssertionError(f"rank {k}: non-finite step {t['steps']}")
    # the last step read what the earlier ZeRO-1 updates wrote: its loss
    # and grad norm agree on every rank, and every parameter block is the
    # same on the data ranks that hold it (same model index)
    last = {k: t["steps"][-1] for k, t in tr.items()}
    if len(tr[0]["steps"]) != MESH_TRAIN_STEPS or any(
            abs(s[key] - last[0][key]) > 1e-6 * abs(last[0][key])
            for s in last.values() for key in ("loss", "grad_norm")):
        raise AssertionError(f"mesh train: last steps differ {last}")
    if not all(blocks_agree.values()):
        raise AssertionError(f"mesh train: parameter blocks differ across "
                             f"the data ranks {blocks_agree}")
    for name in ("engine_fp32", "engine", "granite_engine",
                 "granite_engine_fp32"):
        for r in ranks:
            e = r[name]
            if (e["kernel_launches"] != e["layers"] * e["dispatches"]
                    or e["kernel_launches"] == 0):
                raise AssertionError(f"rank {r['rank']} {name}: launches {e}")
            if not all(s["kv"][:2] == [4 // MESH_SHAPE[0], hkv_local]
                       for s in e["launch_shapes"]
                       if s["kernel"] == "chunk_attn"):
                raise AssertionError(f"rank {r['rank']} {name}: shapes "
                                     f"{e['launch_shapes']}")
            if r[name]["streams"] != r0[name]["streams"]:
                raise AssertionError(f"{name}: rank streams differ")
    # the output within 1e-3 (the reference's bound); each gradient within
    # 1e-3 of its largest entry (a sum over 4096 tokens a rank)
    for k, m in ((r["rank"], r["moe"]) for r in ranks):
        for dispatch, res in m.items():
            if (res["max_abs_err"]["out"] > 1e-3
                    or max(res["rel_err"].values()) > 1e-3):
                raise AssertionError(f"rank {k} moe {dispatch}: {res}")
    rwkv_launches = _emit_mesh_rwkv(ranks, small_streams, rwkv_base)
    rgemma_launches = _emit_mesh_rgemma(ranks, small_streams)
    return {"train": tr, "engine": r0["engine"], "ranks": ranks,
            "rwkv": rwkv_launches, "rgemma": rgemma_launches}


def _train_line(t):
    """A mesh ``train()`` run's report, without the bulky keys."""
    return {k: v for k, v in t.items() if k not in ("comm", "param_checksums",
                                                    "launch_shapes")}


def _engine_line(e):
    return {k: v for k, v in e.items() if k not in ("streams", "comm",
                                                    "launch_shapes")}


def _hold_parity(name, by_rank, launches=None):
    """The mesh-parity limits of PERF.md §2 on every rank (and the exact
    launches, when given)."""
    for k, g in by_rank.items():
        if (g["loss_rel"] > 1e-4 or g["grad_norm_rel"] > 1e-4
                or g["leaf_max_abs"] > 5e-3):
            raise AssertionError(f"rank {k}: {name} mesh gradients vs one "
                                 f"device {g}")
        if launches is not None and g["launches"] != launches:
            raise AssertionError(f"rank {k}: {name} launches {g['launches']}")


def _hold_engine(name, ranks, key, small):
    """The fp32 mesh engine's streams equal one device's on every rank;
    returns the first parts by rank."""
    parts = {r["rank"]: _first_part(r[name][key]["streams"], small)
             for r in ranks}
    if any(p is not None for r in parts.values() for p in r.values()):
        raise AssertionError(f"fp32 mesh {name} engine streams part: {parts}")
    return parts


def _hold_same_streams(name, ranks, key, vocab):
    s0 = ranks[0][name][key]["streams"]
    for r in ranks:
        st = r[name][key]["streams"]
        if st != s0:
            raise AssertionError(f"{name} {key}: rank streams differ")
        if any(len(t) != MESH_NEW_TOKENS or min(t) < 0 or max(t) >= vocab
               for t in st.values()):
            raise AssertionError(f"{name} {key}: a stream is short or holds "
                                 f"an out-of-vocab token: {st}")


def _mesh_step_line(tr):
    by_rank = {k: _train_line(t) for k, t in tr.items()}
    return {"by_rank": by_rank,
            "card_peak_gib_sum": sum(t["peak_gib"] for t in tr.values()),
            "card_reserved_gib_sum": sum(t["reserved_gib"]
                                         for t in tr.values()),
            "staging_share": {k: t["staging_s"] / t["wall_s"]
                              for k, t in tr.items()},
            "comm_share": {k: t["comm_s"] / t["wall_s"]
                           for k, t in tr.items()}}


def _hold_step(name, tr, launches):
    for k, t in tr.items():
        if not all(np.isfinite([s["loss"], s["grad_norm"]]).all()
                   for s in t["steps"]):
            raise AssertionError(f"rank {k}: {name} non-finite step "
                                 f"{t['steps']}")
        if t["kernel_launches"] != launches:
            raise AssertionError(f"rank {k}: {name} launches "
                                 f"{t['kernel_launches']} != {launches}")
    last = [t["steps"][-1] for t in tr.values()]
    if any(abs(s[key] - last[0][key]) > 1e-6 * abs(last[0][key])
           for s in last for key in ("loss", "grad_norm")):
        raise AssertionError(f"{name}: the ranks' steps differ {last}")


def _emit_mesh_rwkv(ranks, small_streams, rwkv_base):
    """Phase 38's lines and holds: rwkv6's fp32 gradients and engine
    streams against one device, its bf16 step and full-depth engine."""
    from repro_torch.configs import get_config

    no_kernel = {"bsa_fwd": 0, "bsa_bwd_dq": 0, "bsa_bwd_dkv": 0}
    gp = {r["rank"]: r["rwkv"]["parity"] for r in ranks}
    e32 = _hold_engine("rwkv", ranks, "engine_fp32", small_streams["rwkv"])
    tr = {r["rank"]: r["rwkv"]["train"] for r in ranks}
    emit({"phase": "mesh_rwkv", "arch": RWKV_ARCH,
          "mesh": dict(zip(("data", "model"), MESH_SHAPE)),
          "seconds_by_rank": {r["rank"]: r["rwkv"]["seconds"] for r in ranks},
          "parity": {"dtype": "float32", "layers": MESH_PARITY_LAYERS,
                     "seq_len": TRAIN["seq"], "batch": TRAIN["batch"],
                     "by_rank": gp},
          "engine_parity": {"dtype": "float32", "layers": MESH_PARITY_LAYERS,
                            "new_tokens": MESH_NEW_TOKENS,
                            "first_part_by_rank": e32,
                            "by_rank": {r["rank"]: _engine_line(
                                r["rwkv"]["engine_fp32"]) for r in ranks}},
          "train": {"layers": MESH_RWKV_TRAIN_LAYERS, "steps": 1,
                    "seq_len": TRAIN["seq"], "batch": TRAIN["batch"],
                    **_mesh_step_line(tr)},
          "engine": {"layers": MESH_RWKV_SERVE_LAYERS,
                     "new_tokens": MESH_NEW_TOKENS,
                     "first_part_vs_phase28": {
                         r["rank"]: _first_part(r["rwkv"]["engine"]["streams"],
                                                rwkv_base) for r in ranks},
                     "by_rank": {r["rank"]: _engine_line(r["rwkv"]["engine"])
                                 for r in ranks}}})
    _hold_parity("rwkv6", gp, no_kernel)
    _hold_step("rwkv6 train", tr, no_kernel)
    _hold_same_streams("rwkv", ranks, "engine", get_config(RWKV_ARCH).vocab)
    return no_kernel


def _emit_mesh_rgemma(ranks, small_streams):
    """Phase 39's lines and holds: recurrentgemma's fp32 gradients (local
    and MRA-2, the kernels on every rank at B = 1, 16 / 1 heads, against
    the plain twins too) and engine streams against one device, and the
    deeper bf16 engine. Returns the MRA-2 gradient's launches by rank."""
    from repro_torch.configs import get_config

    G = MESH_RGEMMA_GROUPS  # one local layer a group, forward twice (remat)
    mra_launches = {"bsa_fwd": 2 * G, "bsa_bwd_dq": G, "bsa_bwd_dkv": G}
    no_kernel = {"bsa_fwd": 0, "bsa_bwd_dq": 0, "bsa_bwd_dkv": 0}
    local = {r["rank"]: r["rgemma"]["parity_local"] for r in ranks}
    mra = {r["rank"]: r["rgemma"]["parity_mra"] for r in ranks}
    mra_plain = {r["rank"]: r["rgemma"]["parity_mra_plain"]["launches"]
                 for r in ranks}
    route = {r["rank"]: r["rgemma"]["mra_kernel_vs_plain"] for r in ranks}
    e32 = _hold_engine("rgemma", ranks, "engine_fp32",
                       small_streams["rgemma"])
    emit({"phase": "mesh_rgemma", "arch": RGEMMA_ARCH,
          "mesh": dict(zip(("data", "model"), MESH_SHAPE)),
          "seconds_by_rank": {r["rank"]: r["rgemma"]["seconds"]
                              for r in ranks},
          "parity": {"dtype": "float32", "groups": G, "seq_len": TRAIN["seq"],
                     "batch": TRAIN["batch"], "local": local, "mra2": mra,
                     "mra2_plain_launches": mra_plain},
          "mra2_kernel_vs_plain": {"tolerance": 1e-4, "by_rank": route},
          "engine_parity": {"dtype": "float32", "groups": G,
                            "new_tokens": MESH_NEW_TOKENS,
                            "local_window": RGEMMA_STREAMS["window"],
                            "prompts": list(RGEMMA_STREAMS["prompts"]),
                            "first_part_by_rank": e32,
                            "by_rank": {r["rank"]: _engine_line(
                                r["rgemma"]["engine_fp32"]) for r in ranks}},
          "engine": {"groups": MESH_RGEMMA_SERVE_GROUPS,
                     "new_tokens": MESH_NEW_TOKENS,
                     "by_rank": {r["rank"]: _engine_line(r["rgemma"]["engine"])
                                 for r in ranks}}})
    _hold_parity("recurrentgemma local", local, no_kernel)
    _hold_parity("recurrentgemma MRA-2", mra, mra_launches)
    if any(n != no_kernel for n in mra_plain.values()):
        raise AssertionError(f"the plain MRA-2 route launched {mra_plain}")
    for k, g in route.items():
        if any(g[key] > 1e-4 for key in ("loss_rel", "grad_norm_rel",
                                         "leaf_rel")):
            raise AssertionError(f"rank {k}: MRA-2 kernels vs plain on the "
                                 f"mesh {g}")
    b = TRAIN["batch"] // MESH_SHAPE[0]
    for k, g in mra.items():  # (rows, n, d): B = 1 a rank, 16 / 1 heads of 256
        if not g["launch_shapes"] or not all(
                s["q"] == [16 * b, TRAIN["seq"], 256]
                and s["kv"] == [b, TRAIN["seq"], 256]
                for s in g["launch_shapes"]):
            raise AssertionError(f"rank {k}: rgemma launch shapes "
                                 f"{g['launch_shapes']}")
    _hold_same_streams("rgemma", ranks, "engine",
                       get_config(RGEMMA_ARCH).vocab)
    return {k: g["launches"] for k, g in mra.items()}


# --------------------------------------------------------------------------- #
# the last slice: the H-level workspace program, head dim 112, the grouped
# far-field draft (phases 46-50)
# --------------------------------------------------------------------------- #
def phase_upper_workspace(torch, tmd, chunk_attn):
    """Phase 46: the H-level program past shared memory (UPPER_WS, NU = 33,
    some entries dead) against its plain twin at the serving tolerance over
    dense and ring windows, timed beside its bound and the plain twin with
    its program, shared memory, workspace bytes, blocks per SM and split;
    then at phase 11's shapes (decode and C = 512) the workspace program
    forced beside the shared one: the same bits, both timed."""
    out, worst, ties, rows = {}, 0.0, 0, 0
    for label, sh, C, mode, dtypes in UPPER_WS:
        err, shape_ties, shape_rows = 0.0, 0, 0
        for i, (layout, dtype) in enumerate(itertools.product(
                ("dense", "ring"), dtypes)):
            pre, k, v, q_pos, ks, vs = kernel_case(
                torch, tmd, SEED + 8000 + i, sh, C, layout, dtype)
            pre = pre._replace(upper=upper_view(
                torch, SEED + 8100 + i, sh["B"], sh["Hkv"], sh["D"],
                UPPER_WS_NU, "some_dead"))
            kw = dict(m=sh["m"], k_scale=ks, v_scale=vs, include_bg=True,
                      mode=mode)
            got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            torch.cuda.synchronize()
            e, t, r = _hold(torch, tmd, got, pre, q_pos, sh["m"], ref,
                            f"H-level {label} {layout} {dtype}")
            err, shape_ties, shape_rows = max(err, e), shape_ties + t, \
                shape_rows + r
            del pre, k, v, got, ref
            torch.cuda.empty_cache()
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, sh, C,
                                               "dense", "bf16")
        pre = pre._replace(upper=upper_view(torch, SEED, sh["B"], sh["Hkv"],
                                            sh["D"], UPPER_WS_NU, "all_live"))
        kw = dict(m=sh["m"], include_bg=True, mode=mode)
        fn = chunk_attn.chunk_attention_kernel
        before = fn.upper_launches
        ms = time_ms(torch, lambda: fn(pre, k, v, q_pos, **kw), 20)
        plain_ms = time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
            pre, k, v, q_pos, **kw), 3)
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, sh["m"])
        info = launch_info(torch, chunk_attn, pre, k, grid, mode, upper=True)
        out[label] = {"shape": sh, "C": C, "mode": mode, "nu": UPPER_WS_NU,
                      "caches_held": list(dtypes), "max_abs_err": err,
                      "near_tie_rows": shape_ties, "rows": shape_rows,
                      "ms": ms,
                      "plain_ms": plain_ms,
                      "timed_upper_launches": fn.upper_launches - before,
                      "program": "workspace" if info["workspace"] else "shared",
                      **bound(pre, k, q_pos, None, grid, pairs,
                              nu=UPPER_WS_NU), **info}
        worst, ties, rows = max(worst, err), ties + shape_ties, \
            rows + shape_rows
        del pre, k, v
        torch.cuda.empty_cache()
        if not info["workspace"]:
            raise AssertionError(f"{label}: not the workspace program")
    if ties > 0.01 * rows:  # phase 2's rule, over the phase's rows
        raise AssertionError(f"H-level workspace: {ties} near-tie rows of "
                             f"{rows}")
    same, times = {}, {}
    for C, mode in ((1, "latency"), (512, "throughput")):
        pre, k, v, q_pos, _, _ = kernel_case(torch, tmd, SEED, UP_MAIN, C,
                                             "dense", "bf16")
        pre = pre._replace(upper=upper_view(torch, SEED, UP_MAIN["B"],
                                            UP_MAIN["Hkv"], UP_MAIN["D"], 33,
                                            "all_live"))
        kw = dict(m=UP_MAIN["m"], include_bg=True, mode=mode)
        a = chunk_attn._launch(pre, k, v, q_pos, workspace=False, **kw)
        b = chunk_attn._launch(pre, k, v, q_pos, workspace=True, **kw)
        same[f"C={C}"] = _same_bits(torch, a, b)
        times[f"C={C}"] = _program_times(torch, chunk_attn, pre, k, v, q_pos,
                                         kw, 100 if C == 1 else 10)
    emit({"phase": "upper_workspace", "atol": ATOL, "rtol": RTOL,
          "max_abs_err": worst, "near_tie_rows": ties, "rows": rows, **out, "phase11_workspace_bitwise": same,
          "phase11_workspace_vs_shared": times})
    if not all(same.values()):
        raise AssertionError(f"H-level workspace program != shared: {same}")
    return worst, out


def _programs_per_sm(torch, chunk_attn, sh, C):
    """Blocks an SM of every program (storage type x level x shared /
    workspace) at ``sh``'s C-query tile, from the occupancy API."""
    occ = {}
    for dt, upper, ws in itertools.product(
            (torch.bfloat16, torch.float32, torch.int8), (False, True),
            (False, True)):
        geo = chunk_attn.plan(sh["B"], sh["Hkv"], sh["G"], C, sh["D"],
                              sh["b"], sh["nb"], dt, workspace=ws,
                              sms=chunk_attn.sm_count(0))
        occ[f"{str(dt)[6:]} C={C} {'upper' if upper else 'two_level'}"
            f"{' workspace' if ws else ''}"] = chunk_attn.blocks_per_sm(
                dt, sh["D"], sh["b"], upper, geo["smem"], ws)
    return occ


def phase_chunk_d112(torch, tmd, chunk_attn, ptx):
    """Phase 47: the chunk kernel at kimi-k2's (112, 128), G = 8, both
    programs (two-level and H-level, NU = 33), bf16 / fp32 / int8 caches,
    decode and C = 128 / 5, dense / ring / ragged, MRA-2 and MRA-2-s, held
    to the plain twin at the serving tolerance; the workspace program at
    KIMI_PAGES (decode at 4096 pages, C = 128 at 1024) held the same way
    (two-level and H-level) and forced beside the shared one at the
    serving shape (the same bits); ptxas and blocks an SM of every D = 112
    program (two an SM, as at D = 128, and no bf16 spill); decode and
    C = 128 timed beside the bound and the plain twin."""
    sh = KIMI_SERVE
    worst, ties, rows, n = 0.0, 0, 0, 0
    for (C, mode), layout, dtype, variant, nu in itertools.product(
            WIDTHS, ("dense", "ring", "ragged"), ("bf16", "fp32", "int8"),
            ("full", "sparse"), (0, 33)):
        if nu and (variant == "sparse" or layout == "ragged"):
            continue
        n += 1
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + 9000 + n,
                                               sh, C, layout, dtype)
        if nu:
            pre = pre._replace(upper=upper_view(
                torch, SEED + 9100 + n, sh["B"], sh["Hkv"], sh["D"], nu,
                "some_dead"))
        kw = dict(m=sh["m"], k_scale=ks, v_scale=vs,
                  include_bg=variant == "full", mode=mode)
        got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
        ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
        torch.cuda.synchronize()
        err, t, r = _hold(torch, tmd, got, pre, q_pos, sh["m"], ref,
                          f"d112 C={C} {layout} {dtype} {variant} NU={nu}")
        worst, ties, rows = max(worst, err), ties + t, rows + r
    pages = {}
    for C, mode, shp in KIMI_PAGES:
        for i, (layout, nu) in enumerate(itertools.product(("dense", "ring"),
                                                           (0, 33))):
            pre, k, v, q_pos, ks, vs = kernel_case(
                torch, tmd, SEED + 9200 + i, shp, C, layout, "bf16")
            if nu:
                pre = pre._replace(upper=upper_view(
                    torch, SEED + 9300 + i, shp["B"], shp["Hkv"], shp["D"],
                    nu, "some_dead"))
            kw = dict(m=shp["m"], include_bg=True, mode=mode)
            geo = chunk_attn.launch_geometry(pre, k.dtype, mode=mode,
                                             sms=chunk_attn.sm_count(0))
            got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            torch.cuda.synchronize()
            err, t, r = _hold(torch, tmd, got, pre, q_pos, shp["m"], ref,
                              f"d112 nb={shp['nb']} C={C} {layout} NU={nu}")
            worst, ties, rows = max(worst, err), ties + t, rows + r
            if not geo["workspace"]:
                raise AssertionError(f"d112 nb={shp['nb']} C={C}: not the "
                                     "workspace program")
            if i == 0:
                ms = time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
                    pre, k, v, q_pos, **kw), 10)
                _, grid, pairs = selection_stats(torch, tmd, pre, q_pos,
                                                 shp["m"])
                pages[f"nb={shp['nb']} C={C}"] = {
                    "ms": ms, **bound(pre, k, q_pos, None, grid, pairs),
                    **launch_info(torch, chunk_attn, pre, k, grid, mode,
                                  upper=False)}
            del pre, k, v, got, ref
            torch.cuda.empty_cache()
    same, ws_time = {}, {}
    for C, mode in ((1, "latency"), (128, "throughput")):
        pre, k, v, q_pos, _, _ = kernel_case(torch, tmd, SEED + 9400, sh, C,
                                             "ring", "bf16")
        kw = dict(m=sh["m"], include_bg=True, mode=mode)
        a = chunk_attn._launch(pre, k, v, q_pos, workspace=False, **kw)
        b = chunk_attn._launch(pre, k, v, q_pos, workspace=True, **kw)
        same[f"C={C}"] = _same_bits(torch, a, b)
        ws_time[f"C={C}"] = _program_times(torch, chunk_attn, pre, k, v,
                                           q_pos, kw, 100)
    occupancy = {**_programs_per_sm(torch, chunk_attn, sh, 1),
                 **_programs_per_sm(torch, chunk_attn, sh, 128)}
    timing = {}
    for label, C, mode, nu in (("decode", 1, "latency", 0),
                               ("chunk128", 128, "throughput", 0),
                               ("upper_decode", 1, "latency", 33),
                               ("upper_chunk128", 128, "throughput", 33)):
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED, sh, C,
                                               "dense", "bf16")
        if nu:
            pre = pre._replace(upper=upper_view(
                torch, SEED + 1, sh["B"], sh["Hkv"], sh["D"], nu, "all_live"))
        kw = dict(m=sh["m"], include_bg=True, mode=mode)
        ms = time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
            pre, k, v, q_pos, **kw), 200)
        plain_ms = time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
            pre, k, v, q_pos, **kw), 20)
        _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, sh["m"])
        timing[label] = {"ms": ms, "plain_ms": plain_ms,
                         **bound(pre, k, q_pos, ks, grid, pairs, nu=nu),
                         **launch_info(torch, chunk_attn, pre, k, grid, mode,
                                       upper=bool(nu))}
    regs = [x for x in ptx if "D=112" in x["kernel"]]
    emit({"phase": "chunk_d112", "shape": sh, "cases": n, "atol": ATOL,
          "rtol": RTOL, "max_abs_err": worst, "near_tie_rows": ties,
          "rows": rows, "pages": pages, "workspace_bitwise": same,
          "workspace_vs_shared": ws_time, "blocks_per_sm": occupancy,
          "ptxas": regs, **timing})
    low = {k: b for k, b in occupancy.items() if b < 2}
    spills = [x for x in regs if x["kernel"].startswith("bf16")
              and (x["spill_stores"] or x["spill_loads"])]
    if ties > 0.01 * rows:
        raise AssertionError(f"{ties} near-tie rows of {rows} exceed 1%")
    if low or spills or len(regs) != 12 or not all(same.values()):
        raise AssertionError(f"D = 112: under two blocks an SM {low}, bf16 "
                             f"spills {spills}, {len(regs)} programs built, "
                             f"workspace bitwise {same}")
    return worst, timing


def phase_bsa_kimi(torch, bsa, ptx):
    """Phase 48: bsa_fwd, bsa_bwd_dq and bsa_bwd_dkv at kimi-k2's (112, 128),
    64 query over 8 KV heads (G = 8), n = 4096, causal, bf16 and fp32, with
    and without padded keys / invalid pairs, against their plain twins at
    phase 22's tolerances (mt at MT_TOL), reruns bit-identical; then timed
    in bf16 beside the bounds and the plain twins with grid, shared memory,
    blocks per SM and ptxas per D = 112 kernel (a bf16 spill, or a bf16
    kernel under (128, 128)'s two blocks an SM, fails it)."""
    sh, G = BSA_KIMI, BSA_KIMI["Hq"] // 8
    worst, n = {}, 0
    _reset_bsa(bsa)
    for dtype, edited in itertools.product((torch.bfloat16, torch.float32),
                                           (False, True)):
        n += 1
        errs, _ = _bsa_hold(torch, bsa, sh, G, dtype, SEED + 700 + n, edited)
        worst = {k: max(worst.get(k, 0.0), e) for k, e in errs.items()}
    timing = _bsa_timing(torch, bsa, sh, G, True)
    regs = [x for x in ptx if "D=112" in x["kernel"]]
    emit({"phase": "bsa_kimi", "shape": sh, "G": G, "cases": n,
          "rtol": BSA_TOL, "atol": BSA_TOL, "mt_atol": MT_TOL,
          "max_abs_err": worst, "bit_identical_reruns": True,
          "phase_launches": _bsa_launches(bsa), "ptxas": regs,
          "timing_bf16": timing})
    low = [key for key, t in timing.items() if t["blocks_per_sm"] < 2]
    spills = [x for x in regs if " bf16 " in x["kernel"]
              and (x["spill_stores"] or x["spill_loads"])]
    if low or spills or len(regs) != 6:
        raise AssertionError(f"bsa (112, 128): under two blocks an SM {low}, "
                             f"bf16 spills {spills}, {len(regs)} built")
    return worst, timing


def _score_rounding(q, k, scale):
    """Four fp32 roundings of the largest partial sum a score of the call
    can reach: 4·2^-24·|q|max·|k|max·scale (row norms; an upper bound of
    Σ_d |q_d·k_d|·scale). Two routes that sum a score in another order part
    by about this; it moves the softmax weights by as much (relative) and
    an output by that times the values' largest magnitude. At unit-scale
    inputs it is ~1e-6; at the saturated logits of a model without
    qk-norm at its seeded init (|q|, |k| ~ 1e2 a row, |v| ~ 1e2) it is
    ~1e-3 on a score and ~1e-1 on an output, where the serving atol (2e-5)
    and the training one (1e-4) cannot hold in fp32 whatever the order."""
    return 4 * 2.0 ** -24 * float(q.float().norm(dim=-1).max()
                                  * k.float().norm(dim=-1).max()) * scale


def _capture(store, fn):
    """``fn`` recording its first call's arguments and result in ``store``
    (tensors cloned: the serving cache updates in place)."""
    def clone(x):
        if isinstance(x, tuple):  # a NamedTuple, or a plain tuple
            items = [clone(y) for y in x]
            return type(x)(*items) if hasattr(x, "_replace") else tuple(items)
        return x.clone() if hasattr(x, "clone") else x

    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        if not store:
            store.update(args=tuple(clone(x) for x in a),
                         kw={k: clone(x) for k, x in kw.items()},
                         out=clone(res))
        return res
    return wrapped


def phase_kimi_full_width(torch, tmd, chunk_attn, bsa):
    """Phase 49: kimi-k2-1t-a32b at full width cut to KIMI["layers"] of its
    61 layers, bf16 weights from a seed (each leaf drawn in fp32: the
    init's peak reported), 384 experts top-8, head dim 112: KIMI's greedy
    requests through ``Engine(slots=2, max_len=4096, chunk=128)`` (the chunk
    kernel at (112, 128): launches = layers x dispatches, combines as
    planned), a torch.profiler breakdown of one decode and one prefill
    dispatch on its cache, then one whole-prompt ``transformer.prefill`` of
    the longest prompt (bsa_fwd at (112, 128), one launch a layer). Held:
    one captured chunk-kernel call (a C = 128 prefill chunk) and the
    captured bsa_fwd call against their plain twins, every prompt token
    prefilled and every requested token generated, every MoE dispatch's
    assignments counted (kept <= tokens x top-8), no non-finite logit.
    Reported: tok/s, prefill / decode wall, the dropped-assignment share,
    the peaks."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe, transformer
    from repro_torch.models.params import init_params, map_specs, materialize
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_config(KIMI_ARCH, num_layers=KIMI["layers"],
                     param_dtype="bfloat16")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    param_gib = (torch.cuda.memory_allocated() - base) / 2**30
    ecfg = EngineConfig(slots=KIMI["slots"], max_len=KIMI["max_len"],
                        chunk=KIMI["chunk"])
    eng = Engine(cfg, params, ecfg, device=DEVICE)
    reqs = _requests(Request, KIMI["prompts"], KIMI["new_tokens"], cfg.vocab)
    bad, kept, total = (torch.zeros((), dtype=torch.int64, device=DEVICE)
                        for _ in range(3))
    routed = torch.zeros((), dtype=torch.int64, device=DEVICE)
    orig_dispatch = moe._dispatch

    def counted(x, idx, **kw):  # kept and total assignments, on the device
        buf, meta = orig_dispatch(x, idx, **kw)
        kept.add_(meta[3].sum())
        total.add_(meta[3].numel())
        routed.add_(idx.numel())
        return buf, meta

    orig = (transformer.prefill_chunk, transformer.decode_step)

    def finite(fn):
        def wrapped(*a, **kw):
            logits, cache = fn(*a, **kw)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, cache
        return wrapped

    chunk_call, launch = {}, chunk_attn._launch
    capture = _capture(chunk_call, launch)

    def launch_kimi(pre, *a, **kw):  # capture the first C = 128 call
        fn = capture if pre.qg.shape[3] == KIMI["chunk"] else launch
        return fn(pre, *a, **kw)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(transformer, "prefill_chunk", finite(orig[0])), \
            mock.patch.object(transformer, "decode_step", finite(orig[1])), \
            mock.patch.object(moe, "_dispatch", counted), \
            mock.patch.object(chunk_attn, "_launch", launch_kimi):
        _reset_chunk(chunk_attn)
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, upper = _chunk_launches(chunk_attn)
        combines = chunk_attn.chunk_attention_kernel.combine_launches
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    st = eng.stats
    dispatches = st["prefill_dispatches"] + st["decode_dispatches"]
    want_comb = _want_combines(chunk_attn, cfg, st, KIMI["slots"],
                               KIMI["chunk"], KIMI["max_len"])
    serve = {"wall_s": wall, "generated_tokens": st["generated_tokens"],
             "tok_per_s": st["generated_tokens"] / wall,
             "prefill_tokens": st["prefill_tokens"],
             "prefill_dispatches": st["prefill_dispatches"],
             "prefill_s": _dispatch_seconds(eng, "prefill_chunk_seconds"),
             "decode_dispatches": st["decode_dispatches"],
             "decode_s": _dispatch_seconds(eng, "decode_step_seconds"),
             "peak_gib": serve_peak, "kernel_launches": launches,
             "combine_launches": combines,
             "assignments": int(total), "dropped": int(total - kept),
             "dropped_share": float(total - kept) / max(float(total), 1.0)}
    # one MoE layer: the profiler's raw sums held against key_averages()
    phase_profile(torch, eng, phase="kimi_profile", check=True)
    # the captured chunk-kernel call against its plain twin
    pre, k, v, q_pos = chunk_call["args"][:4]
    kw = {x: y for x, y in chunk_call["kw"].items()
          if x in ("m", "k_scale", "v_scale", "include_bg", "mode")}
    ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
    torch.cuda.synchronize()
    # the serving tolerance plus the scores' fp32 rounding carried to the
    # output (kimi-k2 has no qk-norm: its seeded logits reach ~1e3)
    chunk_round = _score_rounding(pre.qg, k, pre.scale)
    chunk_slack = chunk_round * float(v.float().abs().max())
    chunk_err, _, _ = _hold(torch, tmd, chunk_call["out"], pre, q_pos,
                            kw["m"], ref, "kimi engine C = 128 call",
                            atol=ATOL + chunk_slack)
    del eng, chunk_call, pre, k, v, ref
    torch.cuda.empty_cache()
    # the whole-prompt prefill of the longest prompt
    S = KIMI["prompts"][0]
    cache = map_specs(transformer.cache_specs(cfg, 1, KIMI["max_len"]),
                      lambda s: materialize(s, DEVICE))
    toks = torch.as_tensor(np.asarray(reqs[0].prompt)[None],
                           dtype=torch.int32, device=DEVICE)
    fwd_call = {}
    _reset_bsa(bsa)
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(bsa, "_forward", _capture(fwd_call, bsa._forward)):
        t0 = time.perf_counter()
        logits, _ = transformer.prefill(params, cfg, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated() / 2**30
    fwd_launches = _bsa_launches(bsa)["bsa_fwd"]
    q, k, v, c, x_idx, y_idx, flags, km, scale, b = fwd_call["args"]
    out, rs, mt = fwd_call["out"][:3]
    ref = bsa.block_sparse_attention_ref(q, k, v, x_idx, y_idx, flags, c, km,
                                         scale=scale, block_size=b)
    # the numerator and row sums at their shared stabilizer mt, each row
    # held in proportion to its weight mass (max(rs, rs_ref)): a row whose
    # exact term the coarse floor c outweighs by e^88 has denormal sums
    # and an ill-defined normalized output, and adds nothing to the
    # layer's output. Tolerances: phase 22's plus the scores' fp32
    # rounding (``_score_rounding``; its seeded logits reach ~1e3)
    s_round = _score_rounding(q, k, scale)
    mass = torch.maximum(rs, ref[1])
    vmax = float(v.float().abs().max())
    bsa_err = {"bsa_fwd": float(((out - ref[0]).abs()
                                 / (1.0 + vmax * mass[..., None])).max()),
               "rowsum_rel": float(((rs - ref[1]).abs()
                                    / mass.clamp(min=1e-30)).max()),
               "mt": float((mt - ref[2]).abs().max())}
    bsa_ok = (bool(((out - ref[0]).abs() <= BSA_TOL + (BSA_TOL + s_round)
                    * vmax * mass[..., None]).all())
              and bool(((rs - ref[1]).abs()
                        <= BSA_TOL + (BSA_TOL + s_round) * mass).all())
              and bsa_err["mt"] <= MT_TOL + s_round
              and torch.equal(rs > 0, ref[1] > 0))
    prefill_finite = bool(torch.isfinite(logits).all())
    emit({"phase": "kimi_full_width", "arch": cfg.name,
          "layers": cfg.num_layers, "of_layers": 61,
          "param_dtype": cfg.param_dtype, "activ_dtype": cfg.activ_dtype,
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
          "head_dim": cfg.hd, "config": KIMI, "init_s": init_s,
          "param_gib": param_gib, "init_peak_gib": init_peak,
          "engine": serve, "chunk_call_max_abs_err": chunk_err,
          "chunk_call_score_rounding": chunk_round,
          "chunk_call_atol": ATOL + chunk_slack,
          "whole_prompt_prefill": {
              "tokens": S, "s": prefill_s, "peak_gib": prefill_peak,
              "bsa_fwd_launches": fwd_launches, "max_abs_err": bsa_err,
              "score_rounding": s_round, "mt_atol": MT_TOL + s_round,
              "q_shape": list(q.shape), "finite_logits": prefill_finite}})
    del params, cache, logits, fwd_call, q, k, v, ref
    torch.cuda.empty_cache()
    if launches != cfg.num_layers * dispatches or upper or combines != want_comb:
        raise AssertionError(f"kimi: {launches} (+{upper}) launches != "
                             f"{cfg.num_layers} x {dispatches}; {combines} "
                             f"combines != {want_comb}")
    if int(bad) or not prefill_finite:
        raise AssertionError(f"kimi: {int(bad)} non-finite logits")
    if (st["prefill_tokens"] != sum(KIMI["prompts"])
            or st["generated_tokens"] != len(reqs) * KIMI["new_tokens"]
            or any(len(r.out) != KIMI["new_tokens"] for r in done)
            or int(total) != int(routed) or int(kept) > int(total)):
        raise AssertionError("kimi: tokens or assignments not conserved")
    if not bsa_ok or fwd_launches != cfg.num_layers:
        raise AssertionError(f"kimi: bsa_fwd {bsa_err} ({fwd_launches} "
                             "launches)")
    return (launches, combines), fwd_launches, chunk_err, bsa_err["bsa_fwd"]


def _with_groups(pre, draft_level):
    """``pre`` with the draft's page groups of ``draft_level``."""
    return pre._replace(group=1 << (draft_level - 1))


def phase_draft_fold(torch, tmd, chunk_attn):
    """Phase 50: the grouped far-field draft. The fold kernel (group sizes
    2 and 4: draft_level 2 and 3) against its plain twin at the serving
    tolerance: the drafts' budget m = 1 and m = 16 at the serving shape
    (B = 4) and with an H-level view (NU = 33) at the long-context one
    (B = 2), dense / ring / ragged, bf16 / int8 / fp32, decode with the
    split planned and forced to 1, and C = 5; a draft call's kernel time
    at draft_level 1 and 2 (m = 1, decode); then phase 14's speculative
    engine at qwen3-1.7b's full width with ``levels=3``, the depth cut to
    SPEC_DRAFT_LAYERS, at draft_level 1 and 2 against plain decoding at
    levels=3 (streams equal, or parting only at phase 14's near tie):
    acceptance, tokens per full dispatch, launches by dispatch kind."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.serve import Engine, EngineConfig, Request, Scheduler
    from repro_torch.serve import engine as engine_mod

    worst, ties, rows, n = 0.0, 0, 0, 0
    for dl, (sh, nu), m, layout, dtype, (C, mode, ns) in itertools.product(
            DRAFT_LEVELS, ((MAIN, 0), (UP_MAIN, 33)), (1, 16),
            ("dense", "ring", "ragged"), ("bf16", "int8", "fp32"),
            ((1, "latency", None), (1, "latency", 1),
             (5, "throughput", None))):
        if nu and layout == "ragged":
            continue
        n += 1
        shm = dict(sh, m=m)
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + 9500 + n,
                                               shm, C, layout, dtype)
        pre = _with_groups(pre, dl)
        if nu:
            pre = pre._replace(upper=upper_view(
                torch, SEED + 9600 + n, sh["B"], sh["Hkv"], sh["D"], nu,
                "some_dead"))
        kw = dict(m=m, k_scale=ks, v_scale=vs, include_bg=True, mode=mode)
        got = chunk_attn._launch(pre, k, v, q_pos, nsplit=ns, **kw)
        ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
        torch.cuda.synchronize()
        err, t, r = _hold(torch, tmd, got, pre, q_pos, m, ref,
                          f"draft_level={dl} NU={nu} m={m} C={C} nsplit={ns} "
                          f"{layout} {dtype}")
        worst, ties, rows = max(worst, err), ties + t, rows + r
    kernel_ms = {}
    pre, k, v, q_pos, _, _ = kernel_case(torch, tmd, SEED, DRAFT_MAIN, 1,
                                         "dense", "bf16")
    for dl in (1, 2):
        p = _with_groups(pre, dl)
        kw = dict(m=1, include_bg=True, mode="latency")
        kernel_ms[f"draft_level={dl}"] = {
            "ms": time_ms(torch, lambda: chunk_attn.chunk_attention_kernel(
                p, k, v, q_pos, **kw), 200),
            "plain_ms": time_ms(torch, lambda: chunk_attn.chunk_attention_ref(
                p, k, v, q_pos, **kw), 20),
            "nsplit": chunk_attn.launch_geometry(
                p, k.dtype, mode="latency",
                sms=chunk_attn.sm_count(0))["nsplit"]}
    _, grid, pairs = selection_stats(torch, tmd, pre, q_pos, 1)
    kernel_ms["bound"] = bound(pre, k, q_pos, None, grid, pairs)
    del pre, k, v
    if ties > 0.01 * rows:
        raise AssertionError(f"draft fold: {ties} near-tie rows of {rows}")
    # the speculative engine at levels=3, plain and at draft_level 1 / 2
    cfg = get_config("qwen3-1.7b", num_layers=SPEC_DRAFT_LAYERS)
    cfg = cfg.replace(attention=dataclasses.replace(cfg.attention, levels=3))
    params = init_params(cfg, seed=SEED, device=DEVICE)
    ecfg = EngineConfig(slots=4, max_len=4096, chunk=128)
    n_new = SPEC["new_tokens"]
    reqs = _requests(Request, SERVE["prompts"], n_new, cfg.vocab)
    (p_sample, p_sched), gaps = _top2_recorder(torch, engine_mod, Scheduler,
                                               cfg.vocab)
    with p_sample, p_sched:
        plain_eng = Engine(cfg, params, ecfg, device=DEVICE)
        t0 = time.perf_counter()
        plain = {len(r.prompt): np.asarray(r.out)
                 for r in plain_eng.run(reqs)}
        plain_wall = time.perf_counter() - t0
    gaps = {n_: torch.stack([torch.stack(g) for g in v]).cpu().numpy()
            for n_, v in gaps.items()}
    plain_per = ((plain_eng.stats["generated_tokens"] - len(reqs))
                 / plain_eng.stats["decode_dispatches"])
    runs = {}
    for dl in (1, 2):
        counts = {k: dict(dispatches=0, launches=0, combines=0)
                  for k in ("prefill", "decode", "draft", "verify")}
        bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
        eng = Engine(cfg, params, ecfg.replace(spec_k=SPEC["spec_k"],
                                               draft_level=dl),
                     device=DEVICE)
        with contextlib.ExitStack() as stack:
            for p in _count_dispatches(torch, transformer, chunk_attn,
                                       counts, bad):
                stack.enter_context(p)
            _reset_chunk(chunk_attn)
            t0 = time.perf_counter()
            done = eng.run(_requests(Request, SERVE["prompts"], n_new,
                                     cfg.vocab))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            two_level = chunk_attn.chunk_attention_kernel.launches
        st = eng.stats
        gen = st["generated_tokens"]
        first = {}
        for r in done:
            got = np.asarray(r.out)
            diff = np.flatnonzero(got != plain[len(r.prompt)])
            if diff.size:
                i = int(diff[0])
                gap, top = gaps[len(r.prompt)][i]
                first[len(r.prompt)] = {"position": i,
                                        "top2_gap": float(gap),
                                        "limit_4_ulps": 4 * _bf16_ulp(top)}
        runs[f"draft_level={dl}"] = {
            "wall_s": wall, "tok_per_s": gen / wall,
            "spec_rounds": st["spec_rounds"],
            "acceptance_rate": st["spec_accepted_tokens"]
            / max(st["spec_drafted_tokens"], 1),
            "tokens_per_full_dispatch": (gen - len(done))
            / (st["verify_dispatches"] + st["decode_dispatches"]),
            "draft_s": _dispatch_seconds(eng, "draft_seconds"),
            "verify_s": _dispatch_seconds(eng, "verify_seconds"),
            "by_kind": counts, "two_level_launches": two_level,
            "identical_streams": not first, "first_divergence": first,
            "non_finite_logits": int(bad)}
        del eng
        for kind, c in counts.items():
            if c["launches"] != cfg.num_layers * c["dispatches"]:
                raise AssertionError(f"draft_level={dl} {kind}: "
                                     f"{c['launches']} launches != "
                                     f"{cfg.num_layers} x {c['dispatches']}")
        if two_level or not st["spec_rounds"] or int(bad):
            raise AssertionError(f"draft_level={dl}: {two_level} two-level "
                                 f"launches at levels=3, {st['spec_rounds']} "
                                 f"rounds, {int(bad)} non-finite logits")
        for n_, f in first.items():
            if not f["top2_gap"] < f["limit_4_ulps"]:
                raise AssertionError(f"draft_level={dl} prompt {n_}: stream "
                                     f"leaves plain decoding's at {f}")
    emit({"phase": "draft_fold", "atol": ATOL, "rtol": RTOL, "cases": n,
          "max_abs_err": worst, "near_tie_rows": ties, "rows": rows,
          "draft_kernel": kernel_ms, "arch": cfg.name,
          "layers": cfg.num_layers, "levels": 3, "spec_k": SPEC["spec_k"],
          "prompts": list(SERVE["prompts"]), "new_tokens": n_new,
          "plain": {"wall_s": plain_wall,
                    "tok_per_s": plain_eng.stats["generated_tokens"]
                    / plain_wall, "decode_tokens_per_dispatch": plain_per},
          **runs})
    del params, plain_eng
    torch.cuda.empty_cache()
    return worst, kernel_ms, runs


def bitwise_dump(path):
    """Outputs of the chunk kernel's existing launches (no draft groups) on
    seeded inputs, saved to ``path`` for a bit-for-bit comparison between
    two trees: phase 2's shapes over widths, layouts and caches (the split
    planned and forced to 1), phase 11's H-level shapes (C = 512 too) and
    phase 40's D = 80. Uses only the wrapper's ``_launch`` and the
    prelude, which both trees have; run it with each tree's ``src`` first
    on ``sys.path``."""
    import torch

    from repro_torch.core import mra_decode as tmd
    from repro_torch.kernels import chunk_attn

    torch.backends.cuda.matmul.allow_tf32 = False
    out, n = {}, 0
    for (name, sh, nu), (C, mode), layout, dtype, ns in itertools.product(
            (("main", MAIN, 0), ("up", UP_MAIN, 33), ("d80", HUBERT_SERVE, 0),
             ("granite", GRANITE, 0)),
            ((1, "latency"), (128, "throughput"), (5, "throughput"),
             (512, "throughput")),
            ("dense", "ring", "ragged"), ("bf16", "int8", "fp32"),
            (None, 1)):
        if (ns == 1 and C != 1) or (C == 512 and not nu):
            continue
        n += 1
        pre, k, v, q_pos, ks, vs = kernel_case(torch, tmd, SEED + n, sh, C,
                                               layout, dtype)
        if nu:
            pre = pre._replace(upper=upper_view(
                torch, SEED + n, sh["B"], sh["Hkv"], sh["D"], nu,
                "some_dead"))
        out[f"{name} C={C} {layout} {dtype} nsplit={ns}"] = chunk_attn._launch(
            pre, k, v, q_pos, m=sh["m"], k_scale=ks, v_scale=vs,
            include_bg=True, mode=mode, nsplit=ns).cpu()
    torch.save(out, path)
    print(json.dumps({"bitwise_dump": str(path), "cases": n}))


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
    build = start_build()
    try:  # phases 28-30 and 32 launch no kernel of this repo: they run
        # meanwhile
        eng, rwkv_base = phase_rwkv_full_width(torch)
        phase_profile(torch, eng, phase="rwkv_profile", kernels=())
        del eng
        torch.cuda.empty_cache()
        phase_rwkv_self(torch)
        torch.cuda.empty_cache()
        phase_rwkv_train(torch)
        torch.cuda.empty_cache()
        eng = phase_rgemma_full_width(torch)  # the local kind: no kernel
        phase_profile(torch, eng, phase="rgemma_profile", kernels=())
        del eng
        torch.cuda.empty_cache()
    finally:  # nothing raises before the compilers have stopped
        join_build(build)
    smi, bsa_ptx, chunk_ptx = phase_device(torch, build)
    # recurrentgemma's training peaks at 70.67 GiB of the card's 79.18: it
    # runs first of the kernel phases, on the cache rwkv6's left empty,
    # before the other phases' allocations fragment it
    rg_err, rg_bsa = phase_bsa_rgemma(torch, bsa, bsa_ptx)
    torch.cuda.empty_cache()
    with _expandable_segments(torch):
        rg_launches = phase_rgemma_train(torch, bsa)
        # kimi-k2's one bf16 layer peaks near 61 GiB at init: on the cache
        # the training phase left empty
        kimi = phase_kimi_full_width(torch, tmd, chunk_attn, bsa)
    max_err, err_by_shape = phase_kernel_vs_plain(torch, tmd, chunk_attn)
    timing = phase_timing(torch, tmd, chunk_attn)
    granite_time = phase_timing(torch, tmd, chunk_attn, GRANITE, MOE_ARCH)
    d80_err, d80_time, hubert_serve = phase_chunk_d80(torch, tmd, chunk_attn)
    torch.cuda.empty_cache()
    long_err, long_pages = phase_chunk_long_pages(torch, tmd, chunk_attn)
    torch.cuda.empty_cache()
    up_ws_err, up_ws = phase_upper_workspace(torch, tmd, chunk_attn)
    torch.cuda.empty_cache()
    d112_err, d112_time = phase_chunk_d112(torch, tmd, chunk_attn, chunk_ptx)
    torch.cuda.empty_cache()
    launches, eng, base = phase_engine_full_width(torch, chunk_attn)
    phase_profile(torch, eng)
    del eng
    phase_engine_parity(torch, chunk_attn)
    torch.cuda.empty_cache()
    moe_launches, eng, moe_base = phase_engine_full_width(
        torch, chunk_attn, arch=MOE_ARCH, phase="moe_full_width",
        new_tokens=FAMILY_SERVE_TOKENS, layers=MOE_SERVE_LAYERS)
    phase_profile(torch, eng, phase="moe_profile")
    phase_moe_drops(torch, eng)
    del eng
    torch.cuda.empty_cache()
    prefill = phase_moe_parity(torch, chunk_attn, bsa)
    torch.cuda.empty_cache()
    bsa_err = phase_bsa_vs_plain(torch, bsa)
    bsa_time, dense_ms = phase_bsa_timing(torch, bsa)
    granite_bsa_err, granite_bsa = phase_bsa_granite(torch, bsa)
    granite_bwd_err, granite_bwd = phase_bsa_granite_bwd(torch, bsa)
    hubert_err, hubert_bsa = phase_bsa_hubert(torch, bsa, bsa_ptx)
    vlm_bsa_err, vlm_bsa = phase_bsa_internvl(torch, bsa)
    kimi_bsa_err, kimi_bsa = phase_bsa_kimi(torch, bsa, bsa_ptx)
    kimi_bsa_launches = _bsa_launches(bsa)
    bsa_launches, _, state = phase_train_full_width(torch, bsa)
    phase_train_profile(torch, state)
    del state
    torch.cuda.empty_cache()
    phase_train_parity(torch, bsa)
    torch.cuda.empty_cache()
    moe_train_launches, state = phase_moe_train_full_width(torch, bsa)
    phase_train_profile(torch, state, phase="moe_train_profile")
    del state
    torch.cuda.empty_cache()
    phase_moe_train_parity(torch, bsa)
    torch.cuda.empty_cache()
    hubert_launches = phase_hubert(torch, bsa)
    vlm_time = phase_timing(torch, tmd, chunk_attn, VLM_SERVE, VLM_ARCH)
    vlm_train_launches, vlm_launches = phase_internvl(torch, bsa, chunk_attn)
    torch.cuda.empty_cache()
    up_err = phase_upper_vs_plain(torch, tmd, chunk_attn)
    up_time = phase_upper_timing(torch, tmd, chunk_attn)
    up_granite = phase_upper_timing(torch, tmd, chunk_attn, UP_GRANITE,
                                    "upper_timing_granite")
    up_launches, eng = phase_long_context(torch, chunk_attn)
    phase_profile(torch, eng, C=LONG["chunk"], phase="long_context_profile")
    del eng
    torch.cuda.empty_cache()
    phase_hier_parity(torch, chunk_attn)
    torch.cuda.empty_cache()
    spec_counts, eng = phase_spec_full_width(torch, chunk_attn, base)
    phase_spec_profile(torch, eng)
    del eng
    torch.cuda.empty_cache()
    phase_spec_parity(torch, chunk_attn)
    torch.cuda.empty_cache()
    fold_err, fold_ms, fold_runs = phase_draft_fold(torch, tmd, chunk_attn)
    torch.cuda.empty_cache()
    h1d_launches, h1d_err, h1d_time = phase_baselines(torch, bsa, bsa_ptx)
    torch.cuda.empty_cache()
    rg_prefill = phase_rgemma_self(torch, bsa)
    torch.cuda.empty_cache()
    mesh = phase_mesh(torch, bsa, chunk_attn, base, moe_base, rwkv_base)
    lm_launches, lm_err, lm_time = phase_train_lm(torch, bsa)
    torch.cuda.empty_cache()
    with _expandable_segments(torch):
        cell_pre = phase_cell_prefill(torch, bsa)
        cell_dec = phase_cell_decode(torch, chunk_attn)
        cell_long = phase_cell_long(torch, bsa, chunk_attn)
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
            "mesh_launches_per_rank": mesh["train"][0]["kernel_launches"][name],
            "shape": "qwen3-1.7b train_4k, B=2, bf16, G=2; "
                     "mesh_launches_per_rank from phase 36's (2, 2) mesh "
                     "train() (local blocks: B=1, 8 query / 4 KV heads)",
            **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                                 "blocks_per_sm", "pairs_per_tile")}})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_fp32_rate",
            "bound_by_fp32_rate", "nsplit", "grid", "smem_bytes",
            "blocks_per_sm", "union_pages_per_tile")
    gdec = granite_time["decode"]
    new_shapes = [{
        "name": "chunk_attn (D=64, b=128)", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_attn.cu",
        "replaces": "src/repro/kernels/chunk_attn.py:93",
        "launches": moe_launches[0], "combine_launches": moe_launches[1],
        "max_abs_err": err_by_shape["granite"],
        "ms": gdec["ms"], "plain_ms": gdec["plain_ms"],
        "bound_ms": gdec["bound_ms"], "bound_by": gdec["bound_by"],
        "bound_ms_fp32_rate": gdec["bound_ms_fp32_rate"],
        "bound_by_fp32_rate": gdec["bound_by_fp32_rate"],
        "nsplit": gdec["nsplit"], "library_ms": None,
        "shape": "granite-moe-3b-a800m decode C=1 (latency), B=4, Hkv=8, "
                 "G=3; chunk128 below; launches from the granite engine run",
        "chunk128": {k: granite_time["chunk128"][k] for k in keys}}, {
        "name": "bsa_fwd (d=64, b=128)", "route": "cuda",
        "source": "src/repro_torch/csrc/block_sparse_attn.cu",
        "replaces": "src/repro/kernels/block_sparse_attn.py:92",
        "launches": moe_train_launches["bsa_fwd"],
        "prefill_launches": sum(x["bsa_fwd_launches"]
                                for x in prefill.values()),
        "max_abs_err": granite_bsa_err,
        "ms": granite_bsa["ms"], "plain_ms": granite_bsa["plain_ms"],
        "bound_ms": granite_bsa["bound_ms_bf16"],
        "bound_by": granite_bsa["bound_by_bf16"], "library_ms": None,
        "bound_ms_fp32_rate": granite_bsa["bound_ms_fp32"],
        "bound_by_fp32_rate": granite_bsa["bound_by_fp32"],
        "shape": "granite-moe-3b-a800m whole-prompt prefill, n=4096, B=1, "
                 "24 query / 8 KV heads, bf16; launches from the 3-step "
                 "granite training run (phase 20), prefill_launches from "
                 "the prefill passes of phase 18 (fp32: 4 + 4 + 1 layers)",
        **{k: granite_bsa[k] for k in ("grid", "threads", "smem_bytes",
                                       "blocks_per_sm")}}]
    for name, key, line in (("bsa_bwd_dq", "dq", 196),
                            ("bsa_bwd_dkv", "dkv", 232)):
        t = granite_bwd[key]
        new_shapes.append({
            "name": f"{name} (d=64, b=128)", "route": "cuda",
            "source": "src/repro_torch/csrc/block_sparse_attn.cu",
            "replaces": f"src/repro/kernels/block_sparse_attn.py:{line}",
            "launches": moe_train_launches[name],
            "max_abs_err": granite_bwd_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
            "library_ms": None,
            "bound_ms_fp32_rate": t["bound_ms_fp32"],
            "bound_by_fp32_rate": t["bound_by_fp32"],
            "shape": "granite-moe-3b-a800m train_4k, n=4096, B=2, 24 query / "
                     "8 KV heads, bf16; launches from the 3-step granite "
                     "training run (phase 20)",
            **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                                 "blocks_per_sm")}})
    vdec = vlm_time["decode"]
    new_shapes.append({
        "name": "chunk_attn (D=64, b=128, G=7)", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_attn.cu",
        "replaces": "src/repro/kernels/chunk_attn.py:93",
        "launches": vlm_launches[0], "combine_launches": vlm_launches[1],
        "max_abs_err": err_by_shape[VLM_ARCH],
        "ms": vdec["ms"], "plain_ms": vdec["plain_ms"],
        "bound_ms": vdec["bound_ms"], "bound_by": vdec["bound_by"],
        "bound_ms_fp32_rate": vdec["bound_ms_fp32_rate"],
        "bound_by_fp32_rate": vdec["bound_by_fp32_rate"],
        "nsplit": vdec["nsplit"], "library_ms": None,
        "shape": "internvl2-1b decode C=1 (latency), B=4, Hkv=2, G=7; "
                 "chunk128 below; launches from the internvl engine run "
                 "(phase 25c)",
        "chunk128": {k: vlm_time["chunk128"][k] for k in keys}})
    for name, key, line in (("bsa_fwd", "fwd", 92), ("bsa_bwd_dq", "dq", 196),
                            ("bsa_bwd_dkv", "dkv", 232)):
        t = hubert_bsa["non_causal"][key]
        new_shapes.append({
            "name": f"{name} (d=80, b=128)", "route": "cuda",
            "source": "src/repro_torch/csrc/block_sparse_attn.cu",
            "replaces": f"src/repro/kernels/block_sparse_attn.py:{line}",
            "launches": hubert_launches[name],
            "max_abs_err": hubert_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
            "library_ms": None,
            "bound_ms_fp32_rate": t["bound_ms_fp32"],
            "bound_by_fp32_rate": t["bound_by_fp32"],
            "causal_ms": hubert_bsa["causal"][key]["ms"],
            "shape": "hubert-xlarge train_4k, n=4096, B=2, 16 MHA heads, "
                     "non-causal, bf16; launches from the 2-step hubert "
                     "training run (phase 24)",
            **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                                 "blocks_per_sm")}})
    for name, key, line in (("bsa_fwd", "fwd", 92), ("bsa_bwd_dq", "dq", 196),
                            ("bsa_bwd_dkv", "dkv", 232)):
        t = vlm_bsa[key]
        new_shapes.append({
            "name": f"{name} (d=64, b=128, G=7)", "route": "cuda",
            "source": "src/repro_torch/csrc/block_sparse_attn.cu",
            "replaces": f"src/repro/kernels/block_sparse_attn.py:{line}",
            "launches": vlm_train_launches[name],
            "max_abs_err": vlm_bsa_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
            "library_ms": None,
            "bound_ms_fp32_rate": t["bound_ms_fp32"],
            "bound_by_fp32_rate": t["bound_by_fp32"],
            "shape": "internvl2-1b train_4k, n=4096, B=4, 14 query / 2 KV "
                     "heads, causal, bf16; launches from the 3-step internvl "
                     "training run (phase 25)",
            **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                                 "blocks_per_sm")}})
    t = h1d_time["fwd"]
    new_shapes.append({
        "name": "bsa_fwd (d=64, b=32)", "route": "cuda",
        "source": "src/repro_torch/csrc/block_sparse_attn.cu",
        "replaces": "src/repro/kernels/block_sparse_attn.py:92",
        "launches": h1d_launches, "max_abs_err": h1d_err["bsa_fwd"],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
        "library_ms": None, "bound_ms_fp32_rate": t["bound_ms_fp32"],
        "bound_by_fp32_rate": t["bound_by_fp32"],
        "shape": "H-Transformer-1D baseline, n=512, B=1, 8 heads, d=64, "
                 "b=32, 3 blocks a row, non-causal, bf16; launches from "
                 "the baselines run (phase 27, fp32 inputs)",
        **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                             "blocks_per_sm")}})
    for name, key, line in (("bsa_fwd", "fwd", 92), ("bsa_bwd_dq", "dq", 196),
                            ("bsa_bwd_dkv", "dkv", 232)):
        t = rg_bsa[key]
        new_shapes.append({
            "name": f"{name} (d=256, b=128)", "route": "cuda",
            "source": "src/repro_torch/csrc/block_sparse_attn.cu",
            "replaces": f"src/repro/kernels/block_sparse_attn.py:{line}",
            "launches": rg_launches[name],
            **({"prefill_launches": rg_prefill} if key == "fwd" else {}),
            "max_abs_err": rg_err[name],
            "mesh_launches_per_rank": {k: v[name] for k, v in
                                       mesh["rgemma"].items()},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
            "library_ms": None,
            "bound_ms_fp32_rate": t["bound_ms_fp32"],
            "bound_by_fp32_rate": t["bound_by_fp32"],
            "shape": "recurrentgemma-9b MRA-2 local layers, train_4k, n=4096, "
                     "B=2, 16 query / 1 KV head, causal, bf16; launches from "
                     f"the 3-step training run at {RGEMMA_TRAIN_GROUPS} "
                     "groups (phase 33), prefill_launches from phase 34's "
                     "whole-prompt prefill, mesh_launches_per_rank from "
                     "phase 39's fp32 gradient on the (2, 2) mesh (local "
                     "blocks: B=1, 16 query / 1 KV head)",
            **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                                 "blocks_per_sm")}})
    chunk_src = dict(route="cuda", source="src/repro_torch/csrc/chunk_attn.cu",
                     replaces="src/repro/kernels/chunk_attn.py:93",
                     library_ms=None)
    bsa_src = dict(route="cuda",
                   source="src/repro_torch/csrc/block_sparse_attn.cu",
                   library_ms=None)
    hdec, lq3 = d80_time["decode"], long_pages["qwen3-1.7b decode"]
    new_shapes.append({
        "name": "chunk_attn (D=80, b=128)", **chunk_src,
        "launches": hubert_serve[0], "combine_launches": hubert_serve[1],
        "max_abs_err": d80_err, "ms": hdec["ms"], "plain_ms": hdec["plain_ms"],
        "bound_ms": hdec["bound_ms"], "bound_by": hdec["bound_by"],
        "shape": "hubert-xlarge decode C=1, B=4, Hkv=16, G=1 (phase 40); "
                 "chunk128 below, and the H-level program (NU=33) at both "
                 "widths; launches from its engine run (16 of 48 layers)",
        **{w: {k: d80_time[w][k] for k in keys}
           for w in ("chunk128", "upper_decode", "upper_chunk128")}})
    new_shapes.append({
        "name": "chunk_attn (nb=4096)", **chunk_src,
        "launches": cell_long["chunk_launches"],
        "combine_launches": cell_long["combines"], "max_abs_err": long_err,
        "ms": lq3["ms"], "plain_ms": lq3["plain_ms"],
        "bound_ms": lq3["bound_ms"], "bound_by": lq3["bound_by"],
        "shape": "long_500k's decode: qwen3-1.7b C=1, B=1, Hkv=8, G=2, int8 "
                 "cache, 4096 pages, the shared-memory program (phase 41); "
                 "launches from the cell's decode (phase 44); the workspace "
                 "program's calls below (phase 41: none on the main paths)",
        **{f"workspace {k}": {f: long_pages[k][f] for f in (
            "ms", "plain_ms", "bound_ms", "bound_by", "nsplit", "grid",
            "smem_bytes", "workspace_bytes")}
           for k in ("qwen2-7b decode", "qwen3-1.7b chunk128")}})
    new_shapes.append({
        "name": "chunk_attn (nb=256, B=16)", **chunk_src,
        "launches": cell_dec["launches"],
        "combine_launches": cell_dec["combines"],
        **{k: cell_dec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
        "shape": "decode_32k: qwen3-1.7b decode C=1, the cell's slots, "
                 "Hkv=8, G=2, 256 pages (phase 43)"})
    for name, cell, key in (("bsa_fwd (n=32768)", cell_pre, "launches"),
                            ("bsa_fwd (n=524288)", cell_long, "bsa_launches")):
        new_shapes.append({
            "name": name, **bsa_src,
            "replaces": "src/repro/kernels/block_sparse_attn.py:92",
            "launches": cell[key], "max_abs_err": cell["max_abs_err"],
            "ms": cell["ms"], "plain_ms": cell["plain_ms"],
            "bound_ms": cell["bound_ms_bf16"],
            "bound_by": cell["bound_by_bf16"],
            "shape": "qwen3-1.7b whole-prompt prefill, B=1, 16 query / 8 KV "
                     "heads, causal, bf16 (phases 42 / 44; the n=524288 "
                     "twin held on the last KV head)"})
    for name, key, line in (("bsa_fwd", "fwd", 92), ("bsa_bwd_dq", "dq", 196),
                            ("bsa_bwd_dkv", "dkv", 232)):
        t = lm_time[key]
        new_shapes.append({
            "name": f"{name} (d=32, b=32, train_lm)", **bsa_src,
            "replaces": f"src/repro/kernels/block_sparse_attn.py:{line}",
            "launches": lm_launches[name], "max_abs_err": lm_err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
            "shape": "examples/train_lm small preset, B=8, n=256, 8 query / "
                     "4 KV heads, causal, bf16 (phase 45)"})
    kdec = d112_time["decode"]
    new_shapes.append({
        "name": "chunk_attn (D=112, b=128)", **chunk_src,
        "launches": kimi[0][0], "combine_launches": kimi[0][1],
        "max_abs_err": d112_err, "kimi_engine_call_abs_err": kimi[2],
        "ms": kdec["ms"],
        "plain_ms": kdec["plain_ms"], "bound_ms": kdec["bound_ms"],
        "bound_by": kdec["bound_by"],
        "shape": "kimi-k2-1t-a32b decode C=1, B=2, Hkv=8, G=8 (phase 47); "
                 "chunk128 and the H-level program (NU=33) below; launches "
                 f"from its engine run ({KIMI['layers']} of 61 layers, bf16 "
                 "weights, phase 49)",
        **{w: {k: d112_time[w][k] for k in keys}
           for w in ("chunk128", "upper_decode", "upper_chunk128")}})
    for label, t in up_ws.items():
        new_shapes.append({
            "name": f"chunk_attn_upper (workspace, {label})", **chunk_src,
            "replaces": "src/repro/kernels/chunk_attn.py:93 (with_upper=True)",
            "launches": t["timed_upper_launches"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            **{k: t[k] for k in ("nsplit", "smem_bytes", "workspace_bytes",
                                 "blocks_per_sm")},
            "shape": f"the H-level workspace program, NU={UPPER_WS_NU}, "
                     f"{label}, B=1 (phase 46; launches: its timed calls "
                     "there, none on the main paths)"})
    for name, key, line in (("bsa_fwd", "fwd", 92), ("bsa_bwd_dq", "dq", 196),
                            ("bsa_bwd_dkv", "dkv", 232)):
        t = kimi_bsa[key]
        new_shapes.append({
            "name": f"{name} (d=112, b=128)", **bsa_src,
            "replaces": f"src/repro/kernels/block_sparse_attn.py:{line}",
            "launches": kimi[1] if key == "fwd" else kimi_bsa_launches[name],
            "max_abs_err": kimi_bsa_err[name],
            **({"kimi_prefill_call_err": kimi[3]} if key == "fwd" else {}),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms_bf16"], "bound_by": t["bound_by_bf16"],
            "bound_ms_fp32_rate": t["bound_ms_fp32"],
            "bound_by_fp32_rate": t["bound_by_fp32"],
            "shape": "kimi-k2-1t-a32b, n=4096, B=1, 64 query / 8 KV heads, "
                     "causal, bf16 (phase 48); launches: bsa_fwd from the "
                     "whole-prompt prefill of phase 49, the backward kernels "
                     "from phase 48's holds (no full-width training step)",
            **{k: t[k] for k in ("grid", "threads", "smem_bytes",
                                 "blocks_per_sm")}})
    fd = fold_ms["draft_level=2"]
    new_shapes.append({
        "name": "chunk_attn (draft fold, gsz=2)", **chunk_src,
        "launches": fold_runs["draft_level=2"]["by_kind"]["draft"]["launches"],
        "max_abs_err": fold_err, "ms": fd["ms"], "plain_ms": fd["plain_ms"],
        "bound_ms": fold_ms["bound"]["bound_ms"],
        "bound_by": fold_ms["bound"]["bound_by"], "nsplit": fd["nsplit"],
        "draft_level_1_ms": fold_ms["draft_level=1"]["ms"],
        "shape": "a draft call: qwen3-1.7b decode C=1, m=1, B=4, Hkv=8, G=2, "
                 "groups of 2 pages (phase 50); launches from the draft "
                 f"dispatches of its levels=3 speculative engine "
                 f"({SPEC_DRAFT_LAYERS} layers)"})
    emit({"kernels": [{
        "name": "chunk_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/chunk_attn.cu",
        "replaces": "src/repro/kernels/chunk_attn.py:93",
        "launches": launches[0], "combine_launches": launches[1],
        "draft_launches": spec_counts["draft"]["launches"],
        "verify_launches": spec_counts["verify"]["launches"],
        "fallback_wave_launches": spec_counts["decode"]["launches"],
        "max_abs_err": max_err,
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "bound_ms_fp32_rate": dec["bound_ms_fp32_rate"],
        "bound_by_fp32_rate": dec["bound_by_fp32_rate"],
        "nsplit": dec["nsplit"], "library_ms": None,
        "mesh_launches_per_rank": mesh["engine"]["kernel_launches"],
        "shape": "decode C=1 (latency), B=4; chunk128 below; "
                 "mesh_launches_per_rank from phase 36's (2, 2) mesh engine "
                 "(local blocks: 2 slots, 4 KV heads)",
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
                     keys + ("two_level_ms",)},
        "granite_d64_b128": {
            "shape": "granite-moe-3b-a800m's (64, 128), B=2, Hkv=8, G=3, "
                     "NU=33, L2-cold (phase 11b); held against the plain "
                     "twin in phase 10",
            "decode": {k: up_granite["decode"][k] for k in
                       keys + ("two_level_ms",)},
            "chunk512": {k: up_granite["chunk512"][k] for k in
                         keys + ("two_level_ms",)}}},
        *train_kernels, *new_shapes]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
