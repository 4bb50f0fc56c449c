"""CUDA kernels of repro_torch on the card, held against their plain versions.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed, and each kernel and its plain twin
run on the same CUDA tensors.

  * ``chunk_attn`` against ``chunk_attention_ref``: atol 2e-5 / rtol 1e-5
    (fp32 sums in another order) on every row whose top-m selection is not
    a near tie (gap between the m-th and (m+1)-th allowed coarse score
    >= 1e-4), and near ties under 1% of rows — the kernel's fused
    multiply-adds may break such a tie the other way.
  * the H-level program of ``chunk_attn`` (collapsed levels + tail) against
    the same plain version with the same view, at the same tolerance, for
    NU = 33 and 65 at the serving shapes (65 would not fit as resident
    tiles) and NU above b at the smoke shapes (two entry tiles).
  * ``chunk_attn`` split across blocks (the split count forced to 1, 2 and
    the planned one at the decode shapes, counts that do not divide nb, a
    union smaller than the count, NU = 65), G = 3 row padding, the fp32
    cache, bitwise reruns, the refused (D, b) and the shared-memory mirror,
    at the same tolerance and near-tie rule.
  * ``chunk_attn`` on four points of the JAX package's serving sweep
    (``tests/test_chunk_kernel.py::FORCED``: plain, paged + int8, ragged
    G = 2, int8 sparse coarse-only) at D = 16, C = 1 and 5, both modes, with
    the sweep's inputs rebuilt here without JAX (``ref_case_inputs``):
    atol 2e-5 / rtol 1e-5 on every row.
  * ``chunk_attn`` at the speculative drafts' budget m = 1 (decode with the
    split forced and planned, a verify-width chunk, the H-level view), and
    the speculative engine on the card: greedy streams equal the plain
    engine's at H = 2 and H = 3, the snapshot/rewind bitwise.
  * ``chunk_attn`` at granite-moe's (D, b) = (64, 128), G = 3 (decode with
    the split forced and planned, C = 128 and 5, bf16 / int8 / fp32, both
    programs), at qwen2-7b's and yi-6b's G = 7 / 8 at (128, 128), and at a
    head dim the wrapper zero-pads (56 -> 64, 12 -> 16), same tolerance and
    near-tie rule; two blocks an SM for every new shape and storage type.
  * the MoE family on the card at the smoke size (fp32): greedy streams
    equal with the plain chunk twin substituted, plain and speculative;
    the whole-prompt ``prefill`` (the block-sparse forward, once a layer)
    leaves ``prefill_chunk``'s cache within 1e-5 normwise and its last
    logits within 1e-4 where both attentions are exact.
  * ``bsa_fwd`` / ``bsa_bwd_dq`` / ``bsa_bwd_dkv`` against
    ``block_sparse_attention_ref`` / ``_bwd_ref``: the normalized numerator
    and the max-scaled gradients at rtol/atol 1e-4, mt at abs 1e-5 (fp32
    sums in another order, split bf16 operands on tensor cores); reruns
    bit-identical; bf16 and fp32 (every operand split) at every built
    (d, b), a padded head dim and a hot key tile; an unbuilt (d, b) is
    refused before any launch; the plan mirrors the library. All three
    also at granite-moe's (64, 128), G = 3, at internvl2-1b's (64, 128),
    G = 7, and at hubert-xlarge's (80, 128), G = 1, causal and non-causal
    (and 72 zero-padded to 80); a one-layer hubert at head dim 80 trains
    on the kernels as on the plain twins; ``chunk_attn`` at internvl2-1b's
    G = 7, (64, 128). The three also at the H-Transformer-1D baseline's
    (64, 32), non-causal.
  * the plain block-sparse twins rerun bitwise on the card (their segment
    sums run in a fixed order); the paper's baselines on the card equal
    the same calls on the CPU within 1e-4 (H-Transformer-1D through
    ``bsa_fwd``); the rwkv6 engine's greedy streams on the card equal the
    CPU's at the smoke size in fp32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import mra_decode as tmd
from repro_torch.core.mra import MraConfig
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels import chunk_attn

ATOL, RTOL, TIE = 2e-5, 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (its plain twin is held against JAX on the CPU)")
    return torch.device("cuda")


def make_inputs(seed, *, B, Hkv, G, D, b, nb, C, layout, dtype, device):
    """Queries, cache and page table for one case (numpy from ``seed``).

    layout: "dense" (every slot full), "ring" (a 1.5x-capacity stream through
    the ring), "ragged" (random lengths, slot 0 empty). Keys carry a random
    per-page offset so coarse scores are spread like real attention rather
    than a near-tie cloud.
    """
    r = np.random.default_rng(seed)
    S = nb * b
    k = r.standard_normal((B, Hkv, S, D)) + np.repeat(
        r.standard_normal((B, Hkv, nb, D)), b, axis=2)
    v = r.standard_normal((B, Hkv, S, D))
    q = r.standard_normal((B, Hkv * G, C, D))
    pb = np.tile(np.arange(nb, dtype=np.int32), (B, 1))
    if layout == "ring":
        lengths = np.full((B,), S + S // 2)
        pb = np.roll(pb + nb // 2, nb // 2, axis=1).astype(np.int32)
    elif layout == "ragged":
        lengths = np.concatenate([[0], r.integers(1, S + 1, B - 1)])
    else:
        lengths = np.full((B,), S)
    q_pos = np.maximum(lengths[:, None] - C, 0) + np.arange(C)

    def dev(x, dt):
        return torch.as_tensor(x, dtype=dt, device=device)

    k, v = dev(k, torch.float32), dev(v, torch.float32)
    ks = vs = None
    if dtype == "int8":
        k, ks = tmd.quantize_kv(k)
        v, vs = tmd.quantize_kv(v)
    elif dtype == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return (dev(q, torch.float32), k, v, dev(lengths, torch.int32),
            dev(q_pos, torch.int32), dev(pb, torch.int32), ks, vs)


def pyramid_of(k, v, lengths, pb, ks, vs, b):
    """fp32 page sums of the live (dequantized) tokens — the engine's pyramid."""
    B, Hkv, S, D = k.shape
    mask = tmd.paged_position_mask(lengths, pb, S, b).to(torch.float32)
    out = []
    for x, sc in ((k, ks), (v, vs)):
        xf = x.to(torch.float32) * (sc[..., None] if sc is not None else 1.0)
        out.append((xf * mask[:, None, :, None]).reshape(
            B, Hkv, S // b, b, D).sum(3))
    return tmd.PyramidState(*out)


def selection_margin(pre, q_pos, m):
    """(B, Hkv, G, C) gap between the m-th and (m+1)-th allowed selection
    score of the plain version (inf where fewer than m+1 pages are allowed)."""
    sel = tmd._select_pages(pre, q_pos, m + 1)
    scores = torch.where(sel.allowed, sel.coarse_m + 2e9 * sel.ownl, -torch.inf)
    top = torch.sort(scores, dim=-1, descending=True).values
    if top.shape[-1] <= m:
        return torch.full(top.shape[:-1], torch.inf, device=top.device)
    gap = top[..., m - 1] - top[..., m]
    return torch.where(torch.isfinite(gap), gap, torch.inf)


def compare(pre, k, v, q_pos, m, ks, vs, include_bg, mode, nsplit=None):
    """(max |err| over non-tie rows, near-tie rows, rows) of kernel vs plain;
    ``nsplit`` forces the kernel's split count (the private launcher)."""
    kw = dict(m=m, k_scale=ks, v_scale=vs, include_bg=include_bg, mode=mode)
    if nsplit is None:
        got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
    else:
        got = chunk_attn._launch(pre, k, v, q_pos, nsplit=nsplit, **kw)
    ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
    torch.cuda.synchronize()
    B, Hkv, G, C, D = pre.qg.shape
    tie = (selection_margin(pre, q_pos, m) < TIE).reshape(B, Hkv * G, C)
    keep = ~tie[..., None]
    ok = torch.isclose(got, ref, atol=ATOL, rtol=RTOL) | ~keep
    assert bool(ok.all()), (
        f"kernel != plain: max err {float((got - ref).abs()[keep.expand_as(got)].max())}")
    err = float(torch.where(keep, (got - ref).abs(), 0.0).max())
    return err, int(tie.sum()), tie.numel()


SHAPES = {"main": dict(B=4, Hkv=8, G=2, D=128, b=128, nb=32, m=16),
          "smoke": dict(B=4, Hkv=2, G=2, D=16, b=16, nb=4, m=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("C,mode", [(1, "latency"), (5, "throughput"),
                                    (128, "throughput"), (5, "latency")])
def test_chunk_attn_kernel_matches_plain(cuda, shape, C, mode):
    sh = SHAPES[shape]
    ties = rows = 0
    for i, (layout, dtype, variant) in enumerate(itertools.product(
            ("dense", "ring", "ragged"), ("bf16", "int8"), ("full", "sparse"))):
        q, k, v, lengths, q_pos, pb, ks, vs = make_inputs(
            i, B=sh["B"], Hkv=sh["Hkv"], G=sh["G"], D=sh["D"], b=sh["b"],
            nb=sh["nb"], C=C, layout=layout, dtype=dtype, device=cuda)
        cfg = MraConfig(block_size=sh["b"], variant=variant)
        pyr = pyramid_of(k, v, lengths, pb, ks, vs, sh["b"])
        pre = tmd._chunk_prelude(q, k, v, lengths, q_pos, cfg, sh["m"], pyr, pb)
        _, t, n = compare(pre, k, v, q_pos, sh["m"], ks, vs,
                          variant == "full", mode)
        ties, rows = ties + t, rows + n
    assert ties <= 0.01 * rows, f"{ties} near-tie rows of {rows}"


@pytest.mark.cuda
def test_chunk_attn_kernel_counts_launches_and_rejects_bad_input(cuda):
    sh = SHAPES["smoke"]
    q, k, v, lengths, q_pos, pb, ks, vs = make_inputs(
        0, B=2, Hkv=2, G=2, D=16, b=16, nb=4, C=3, layout="dense",
        dtype="bf16", device=cuda)
    cfg = MraConfig(block_size=sh["b"])
    pre = tmd._chunk_prelude(q, k, v, lengths, q_pos, cfg, 2, None, pb)
    before = chunk_attn.chunk_attention_kernel.launches
    chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, m=2)
    assert chunk_attn.chunk_attention_kernel.launches == before + 1
    with pytest.raises(ValueError, match="dtype"):
        chunk_attn.chunk_attention_kernel(pre, k.half(), v.half(), q_pos, m=2)
    with pytest.raises(ValueError, match="contiguous"):
        chunk_attn.chunk_attention_kernel(
            pre, k.transpose(2, 3).contiguous().transpose(2, 3), v, q_pos, m=2)


def upper_of(seed, B, Hkv, D, NU, pattern, device):
    """A random H-level view (core.hier.HierUpper) of NU entries; pattern:
    all_live | some_dead | all_dead | tail_only. A few entries carry 3x keys
    so that their scores can lead the row stabilizer."""
    from repro_torch.core.hier import HierUpper

    r = np.random.default_rng(seed)
    km = r.standard_normal((B, Hkv, NU, D)).astype(np.float32)
    km[:, :, 1:3] *= 3.0
    vm = r.standard_normal((B, Hkv, NU, D)).astype(np.float32)
    cnt = r.integers(1, 257, (B, NU)).astype(np.float32)
    if pattern == "some_dead":
        cnt[:, ::2] = 0.0
    elif pattern == "all_dead":
        cnt[:] = 0.0
    elif pattern == "tail_only":
        cnt[:, :-1] = 0.0
    return HierUpper(*(torch.as_tensor(x, device=device) for x in (km, vm, cnt)))


UPPER_CASES = [("main", 33), ("main", 65), ("smoke", 5), ("smoke", 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,NU", UPPER_CASES)
@pytest.mark.parametrize("C,mode", [(1, "latency"), (5, "throughput")])
def test_chunk_attn_upper_kernel_matches_plain(cuda, shape, NU, C, mode):
    sh = SHAPES[shape]
    ties = rows = 0
    for i, (layout, dtype, pattern) in enumerate(itertools.product(
            ("ring", "ragged"), ("bf16", "int8"),
            ("all_live", "some_dead", "all_dead", "tail_only"))):
        q, k, v, lengths, q_pos, pb, ks, vs = make_inputs(
            i, B=sh["B"], Hkv=sh["Hkv"], G=sh["G"], D=sh["D"], b=sh["b"],
            nb=sh["nb"], C=C, layout=layout, dtype=dtype, device=cuda)
        cfg = MraConfig(block_size=sh["b"])
        pyr = pyramid_of(k, v, lengths, pb, ks, vs, sh["b"])._replace(
            upper=upper_of(i, sh["B"], sh["Hkv"], sh["D"], NU, pattern, cuda))
        pre = tmd._chunk_prelude(q, k, v, lengths, q_pos, cfg, sh["m"], pyr, pb)
        before = chunk_attn.chunk_attention_kernel.upper_launches
        _, t, n = compare(pre, k, v, q_pos, sh["m"], ks, vs, True, mode)
        assert chunk_attn.chunk_attention_kernel.upper_launches == before + 1
        ties, rows = ties + t, rows + n
        if layout == "ragged" and pattern != "all_dead":  # slot 0: no window
            out = chunk_attn.chunk_attention_kernel(
                pre, k, v, q_pos, m=sh["m"], k_scale=ks, v_scale=vs, mode=mode)
            assert bool((out[0].abs().amax(-1) > 0).all())
    assert ties <= 0.01 * rows, f"{ties} near-tie rows of {rows}"


@pytest.mark.cuda
def test_chunk_attn_upper_program_counts_apart_and_skips_under_mra2_s(cuda):
    """MRA-2-s ignores the view: the two-level program runs and gives the
    same result as without it; the fold's launches are counted apart."""
    sh = SHAPES["smoke"]
    q, k, v, lengths, q_pos, pb, ks, vs = make_inputs(
        3, B=sh["B"], Hkv=sh["Hkv"], G=sh["G"], D=sh["D"], b=sh["b"],
        nb=sh["nb"], C=3, layout="ring", dtype="bf16", device=cuda)
    cfg = MraConfig(block_size=sh["b"], variant="sparse")
    pyr = pyramid_of(k, v, lengths, pb, ks, vs, sh["b"])
    up = upper_of(0, sh["B"], sh["Hkv"], sh["D"], 9, "all_live", cuda)
    with_up = tmd._chunk_prelude(q, k, v, lengths, q_pos, cfg, 2,
                                 pyr._replace(upper=up), pb)
    plain = tmd._chunk_prelude(q, k, v, lengths, q_pos, cfg, 2, pyr, pb)
    fn = chunk_attn.chunk_attention_kernel
    two, upper = fn.launches, fn.upper_launches
    a = fn(with_up, k, v, q_pos, m=2, include_bg=False)
    b = fn(plain, k, v, q_pos, m=2, include_bg=False)
    assert torch.equal(a, b)
    assert (fn.launches, fn.upper_launches) == (two + 2, upper)
    fn(with_up, k, v, q_pos, m=2)
    assert (fn.launches, fn.upper_launches) == (two + 2, upper + 1)
    with pytest.raises(ValueError, match="upper counts"):
        fn(with_up._replace(upper=up._replace(counts=up.counts[:, :-1])),
           k, v, q_pos, m=2)


# ---- the split decode, row padding and the fp32 cache (tensor-core body) ----
DECODE = {"main": dict(B=4, Hkv=8, G=2, D=128, b=128, nb=32, m=16),
          "long": dict(B=2, Hkv=8, G=2, D=128, b=128, nb=32, m=16)}


def prelude(seed, sh, C, layout, dtype, device, variant="full", upper=None):
    """(pre, k, v, q_pos, ks, vs) of one case, with the engine's pyramid."""
    q, k, v, lengths, q_pos, pb, ks, vs = make_inputs(
        seed, B=sh["B"], Hkv=sh["Hkv"], G=sh["G"], D=sh["D"], b=sh["b"],
        nb=sh["nb"], C=C, layout=layout, dtype=dtype, device=device)
    pyr = pyramid_of(k, v, lengths, pb, ks, vs, sh["b"])._replace(upper=upper)
    cfg = MraConfig(block_size=sh["b"], variant=variant)
    return (tmd._chunk_prelude(q, k, v, lengths, q_pos, cfg, sh["m"], pyr, pb),
            k, v, q_pos, ks, vs)


def planned(pre, mode="auto"):
    return chunk_attn.launch_geometry(
        pre, torch.bfloat16, mode=mode,
        sms=chunk_attn.sm_count(torch.cuda.current_device()))["nsplit"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(DECODE))
@pytest.mark.parametrize("nsplit", [1, 2, "plan"])
def test_chunk_attn_forced_splits_match_plain(cuda, shape, nsplit):
    """Decode at the serving (B = 4) and long-context (B = 2) shapes with the
    split count forced to 1, 2 and the planned one; the combine launches
    exactly when the count is above 1."""
    sh = DECODE[shape]
    ties = rows = 0
    for i, (layout, dtype, variant) in enumerate(itertools.product(
            ("dense", "ring", "ragged"), ("bf16", "int8"), ("full", "sparse"))):
        pre, k, v, q_pos, ks, vs = prelude(i, sh, 1, layout, dtype, cuda,
                                           variant)
        ns = planned(pre) if nsplit == "plan" else nsplit
        assert nsplit != "plan" or ns * sh["B"] * sh["Hkv"] >= 264
        before = chunk_attn.chunk_attention_kernel.combine_launches
        _, t, n = compare(pre, k, v, q_pos, sh["m"], ks, vs,
                          variant == "full", "latency", nsplit=ns)
        assert (chunk_attn.chunk_attention_kernel.combine_launches
                == before + (ns > 1))
        ties, rows = ties + t, rows + n
    assert ties <= 0.01 * rows, f"{ties} near-tie rows of {rows}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,C,nsplit", [
    ("main", 1, 1), ("main", 1, 2), ("main", 1, "plan"), ("main", 5, None),
    ("long", 1, None), ("long", 5, None)])
def test_chunk_attn_budget_one_matches_plain(cuda, shape, C, nsplit):
    """The speculative drafts' budget m = 1 (own block only): most splits of
    a decode row hold no selected page and must add nothing to the merge;
    at long context with an H-level view (NU = 33) folded in by split 0."""
    sh = dict(DECODE[shape], m=1)
    mode = "latency" if C == 1 else "throughput"
    for i, (layout, dtype, variant) in enumerate(itertools.product(
            ("dense", "ring", "ragged"), ("bf16", "int8"), ("full", "sparse"))):
        up = (upper_of(40 + i, sh["B"], sh["Hkv"], sh["D"], 33, "all_live",
                       cuda) if shape == "long" else None)
        pre, k, v, q_pos, ks, vs = prelude(40 + i, sh, C, layout, dtype, cuda,
                                           variant, upper=up)
        ns = planned(pre) if nsplit == "plan" else nsplit
        compare(pre, k, v, q_pos, 1, ks, vs, variant == "full", mode,
                nsplit=ns)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,nsplit", [(24, 16), (20, 8), (12, 8)])
def test_chunk_attn_split_ranges_nsplit_does_not_divide(cuda, nb, nsplit):
    sh = dict(DECODE["main"], nb=nb, m=6)
    for i, layout in enumerate(("dense", "ring", "ragged")):
        pre, k, v, q_pos, ks, vs = prelude(10 + i, sh, 1, layout, "bf16", cuda)
        compare(pre, k, v, q_pos, sh["m"], ks, vs, True, "latency",
                nsplit=nsplit)


@pytest.mark.cuda
def test_chunk_attn_split_union_smaller_than_nsplit(cuda):
    """m = 2 selects at most four pages for the tile's two rows: most of the
    16 splits find no page in their range and hand in empty partials."""
    sh = dict(DECODE["main"], m=2)
    for i, dtype in enumerate(("bf16", "int8")):
        pre, k, v, q_pos, ks, vs = prelude(20 + i, sh, 1, "ring", dtype, cuda)
        sel = tmd._select_pages(pre, q_pos, sh["m"])
        grid = torch.zeros(sel.coarse_m.shape, dtype=torch.bool,
                           device=cuda).scatter_(-1, sel.y_idx, sel.sel_ok)
        assert int(grid.any(3).any(2).sum(-1).max()) < 16
        for variant in (True, False):
            compare(pre, k, v, q_pos, sh["m"], ks, vs, variant, "latency",
                    nsplit=16)


@pytest.mark.cuda
@pytest.mark.parametrize("nsplit", [1, 2, "plan"])
def test_chunk_attn_upper_split_nu65(cuda, nsplit):
    """The H-level program with NU = 65 (five entry tiles) under splits:
    split 0 folds the entries, the combine merges."""
    sh = DECODE["long"]
    for i, (layout, pattern) in enumerate(itertools.product(
            ("ring", "ragged"), ("all_live", "some_dead", "tail_only"))):
        up = upper_of(30 + i, sh["B"], sh["Hkv"], sh["D"], 65, pattern, cuda)
        pre, k, v, q_pos, ks, vs = prelude(30 + i, sh, 1, layout, "bf16",
                                           cuda, upper=up)
        ns = planned(pre) if nsplit == "plan" else nsplit
        before = chunk_attn.chunk_attention_kernel.upper_launches
        compare(pre, k, v, q_pos, sh["m"], ks, vs, True, "latency",
                nsplit=ns)
        assert chunk_attn.chunk_attention_kernel.upper_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("C,mode", [(1, "latency"), (8, "throughput"),
                                    (13, "throughput")])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp32"])
def test_chunk_attn_g3_row_padding(cuda, C, mode, dtype):
    """llama3.2-3b's G = 3: 3 rows padded to one m16 tile at decode, 24
    rows to two at C_tile = 8 (and a ragged last tile at C = 13)."""
    sh = dict(DECODE["main"], G=3)
    ties = rows = 0
    for i, (layout, variant) in enumerate(itertools.product(
            ("dense", "ring", "ragged"), ("full", "sparse"))):
        pre, k, v, q_pos, ks, vs = prelude(40 + i, sh, C, layout, dtype, cuda,
                                           variant)
        _, t, n = compare(pre, k, v, q_pos, sh["m"], ks, vs,
                          variant == "full", mode)
        ties, rows = ties + t, rows + n
    assert ties <= 0.01 * rows, f"{ties} near-tie rows of {rows}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("C,mode", [(1, "latency"), (5, "throughput")])
def test_chunk_attn_fp32_cache_matches_plain(cuda, shape, C, mode):
    """The fp32 cache (fp32-activation engines) through the six-product
    split, with and without an H-level view."""
    sh = SHAPES[shape]
    for i, layout in enumerate(("dense", "ring", "ragged")):
        for up in (None, upper_of(i, sh["B"], sh["Hkv"], sh["D"], 33,
                                  "some_dead", cuda)):
            pre, k, v, q_pos, ks, vs = prelude(50 + i, sh, C, layout, "fp32",
                                               cuda, upper=up)
            compare(pre, k, v, q_pos, sh["m"], ks, vs, True, mode)


@dataclasses.dataclass(frozen=True)
class RefCase:
    """A point of the JAX package's serving sweep
    (``tests/test_chunk_kernel.py::Case``), with its defaults."""

    paged: bool = False        # ring layout (stream longer than the cache)
    quant: bool = False        # int8 pages + per-token scales
    coarse_only: bool = False  # m = 1: own block + pyramid background only
    group: int = 1             # GQA: Hq = group * Hkv
    ragged: bool = False       # per-slot lengths (incl. a zero-length slot)
    variant: str = "full"
    B: int = 2
    Hkv: int = 2
    S: int = 64
    D: int = 8
    b: int = 16
    m: int = 3
    seed: int = 0


def ref_case_inputs(case: RefCase, *, C: int):
    """(q, k, v, lengths, q_pos, page_blocks, k_scale, v_scale) on the CPU:
    ``tests/test_chunk_kernel.py::make_case_inputs`` without JAX — the same
    numpy draws from the case's seed in the same order, rounded to fp32, and
    the port's ``quantize_kv``."""
    r = np.random.default_rng(case.seed)
    B, Hkv, S, D, b = case.B, case.Hkv, case.S, case.D, case.b
    nb = S // b

    def f32(shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32))

    k, v = f32((B, Hkv, S, D)), f32((B, Hkv, S, D))
    q = f32((B, Hkv * case.group, C, D))
    page_blocks = None
    if case.paged:  # logical blocks nb/2 .. 3nb/2 - 1, block y on page y % nb
        lengths = np.full((B,), S + S // 2)
        page_blocks = torch.from_numpy(np.roll(np.tile(
            np.arange(nb, dtype=np.int32) + nb // 2, (B, 1)), nb // 2, axis=1))
    elif case.ragged:
        lengths = np.array([0] + list(r.integers(1, S + 1, B - 1)))
    else:
        lengths = np.full((B,), S)
    q_pos = np.maximum(lengths[:, None] - C, 0) + np.arange(C)
    k_scale = v_scale = None
    if case.quant:
        k, k_scale = tmd.quantize_kv(k)
        v, v_scale = tmd.quantize_kv(v)
    return (q, k, v, torch.from_numpy(lengths.astype(np.int32)),
            torch.from_numpy(q_pos.astype(np.int32)), page_blocks, k_scale,
            v_scale)


# tests/test_chunk_kernel.py::FORCED
REF_CASES = (RefCase(), RefCase(paged=True, quant=True, seed=21),
             RefCase(ragged=True, group=2, seed=33),
             RefCase(quant=True, variant="sparse", coarse_only=True, seed=40))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_cuda_kernel_matches_plain_version(cuda, mode):
    """The CUDA kernel == its plain twin on the same CUDA tensors (atol 2e-5
    / rtol 1e-5 on every row), across the paged / int8 / ragged / sparse
    points of the reference sweep, at the head dim the kernel is built for
    with b = 16 (D = 16)."""
    for case in REF_CASES:
        case = dataclasses.replace(case, D=16)
        for C in (1, 5):
            q, k, v, lengths, q_pos, pb, ks, vs = (
                None if x is None else x.to(cuda)
                for x in ref_case_inputs(case, C=C))
            cfg = MraConfig(block_size=case.b, variant=case.variant)
            m = 1 if case.coarse_only else case.m
            pre = tmd._chunk_prelude(q, k, v, lengths, q_pos, cfg, m, None, pb)
            kw = dict(m=m, k_scale=ks, v_scale=vs,
                      include_bg=case.variant == "full", mode=mode)
            got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
            ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_chunk_attn_reruns_are_bit_identical(cuda):
    sh = DECODE["long"]
    up = upper_of(60, sh["B"], sh["Hkv"], sh["D"], 33, "all_live", cuda)
    for C, mode in ((1, "latency"), (64, "throughput")):
        pre, k, v, q_pos, ks, vs = prelude(60, sh, C, "ring", "bf16", cuda,
                                           upper=up)
        for ns in (None, 4):
            runs = [chunk_attn._launch(pre, k, v, q_pos, m=sh["m"], mode=mode,
                                       nsplit=ns) for _ in range(2)]
            torch.cuda.synchronize()
            assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
def test_chunk_attn_refuses_an_unbuilt_shape_and_mirrors_smem(cuda):
    # D = 40 pads to 48, which is not built (D = 8 would pad to a built 16)
    q, k, v, lengths, q_pos, pb, ks, vs = make_inputs(
        0, B=2, Hkv=2, G=2, D=40, b=16, nb=4, C=1, layout="dense",
        dtype="bf16", device=cuda)
    pre = tmd._chunk_prelude(q, k, v, lengths, q_pos, MraConfig(block_size=16),
                             2, None, pb)
    with pytest.raises(ValueError, match=r"\(128, 128\), \(16, 16\)"):
        chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, m=2)
    lib = chunk_attn._library()
    for dt, (D, b), G, c_tile in itertools.product(
            (torch.bfloat16, torch.int8, torch.float32), chunk_attn.KERNEL_SHAPES,
            (2, 3), (1, 8)):
        nb = 4096 // b if D == 128 else 4
        want = chunk_attn.smem_bytes(G, c_tile, D, b, nb, dt)
        assert lib.chunk_attn_smem_bytes(chunk_attn._CACHE_DTYPES[dt], D, b,
                                         G * c_tile, nb) == want
        if D == 128:
            assert chunk_attn.blocks_per_sm(dt, D, b, True, want) >= 2


# ---- head dim 64 at block 128 (granite-moe-3b-a800m, G = 3), the 7 and 8
# query heads per KV head of qwen2-7b and yi-6b, a padded head dim ----------
GRANITE = dict(B=4, Hkv=8, G=3, D=64, b=128, nb=32, m=16)


@pytest.mark.cuda
@pytest.mark.parametrize("C,mode,nsplit", [
    (1, "latency", 1), (1, "latency", "plan"), (128, "throughput", None),
    (5, "throughput", None)])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "fp32"])
def test_chunk_attn_granite_shape_matches_plain(cuda, C, mode, nsplit, dtype):
    """(D, b) = (64, 128), G = 3: two warps split D; decode with the split
    forced to 1 and planned, the prefill chunk (C_tile = 8: 24 rows) and a
    verify-width chunk, every storage type, MRA-2 and MRA-2-s."""
    ties = rows = 0
    for i, (layout, variant) in enumerate(itertools.product(
            ("dense", "ring", "ragged"), ("full", "sparse"))):
        pre, k, v, q_pos, ks, vs = prelude(70 + i, GRANITE, C, layout, dtype,
                                           cuda, variant)
        ns = planned(pre) if nsplit == "plan" else nsplit
        before = chunk_attn.chunk_attention_kernel.launches
        _, t, n = compare(pre, k, v, q_pos, GRANITE["m"], ks, vs,
                          variant == "full", mode, nsplit=ns)
        assert chunk_attn.chunk_attention_kernel.launches == before + 1
        ties, rows = ties + t, rows + n
    assert ties <= 0.01 * rows, f"{ties} near-tie rows of {rows}"


@pytest.mark.cuda
@pytest.mark.parametrize("C,mode", [(1, "latency"), (5, "throughput")])
def test_chunk_attn_upper_granite_shape_matches_plain(cuda, C, mode):
    """The H-level program at (64, 128) with NU = 33."""
    sh = GRANITE
    for i, (layout, dtype, pattern) in enumerate(itertools.product(
            ("ring", "ragged"), ("bf16", "int8"),
            ("all_live", "some_dead", "tail_only"))):
        up = upper_of(80 + i, sh["B"], sh["Hkv"], sh["D"], 33, pattern, cuda)
        pre, k, v, q_pos, ks, vs = prelude(80 + i, sh, C, layout, dtype, cuda,
                                           upper=up)
        before = chunk_attn.chunk_attention_kernel.upper_launches
        compare(pre, k, v, q_pos, sh["m"], ks, vs, True, mode)
        assert chunk_attn.chunk_attention_kernel.upper_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("G", [7, 8])
@pytest.mark.parametrize("C,mode", [(1, "latency"), (128, "throughput")])
def test_chunk_attn_qwen2_and_yi_heads_match_plain(cuda, G, C, mode):
    """qwen2-7b (G = 7) and yi-6b (G = 8) at (128, 128), 4 KV heads: a
    throughput tile of 4 positions holds 28 / 32 rows."""
    sh = dict(DECODE["main"], Hkv=4, G=G)
    ties = rows = 0
    for i, (layout, dtype) in enumerate(itertools.product(
            ("dense", "ring", "ragged"), ("bf16", "int8"))):
        pre, k, v, q_pos, ks, vs = prelude(90 + i, sh, C, layout, dtype, cuda)
        _, t, n = compare(pre, k, v, q_pos, sh["m"], ks, vs, True, mode)
        ties, rows = ties + t, rows + n
    assert ties <= 0.01 * rows, f"{ties} near-tie rows of {rows}"


@pytest.mark.cuda
@pytest.mark.parametrize("C,mode", [(1, "latency"), (128, "throughput")])
def test_chunk_attn_internvl_heads_match_plain(cuda, C, mode):
    """internvl2-1b's 14 query heads over 2 KV heads (G = 7) at (64, 128):
    a throughput tile of 4 positions holds 28 of 32 rows, a decode tile 7
    of 16."""
    sh = dict(DECODE["main"], Hkv=2, G=7, D=64)
    ties = rows = 0
    for i, (layout, dtype) in enumerate(itertools.product(
            ("dense", "ring", "ragged"), ("bf16", "int8"))):
        pre, k, v, q_pos, ks, vs = prelude(110 + i, sh, C, layout, dtype, cuda)
        _, t, n = compare(pre, k, v, q_pos, sh["m"], ks, vs, True, mode)
        ties, rows = ties + t, rows + n
    assert ties <= 0.01 * rows, f"{ties} near-tie rows of {rows}"


@pytest.mark.cuda
@pytest.mark.parametrize("D,b", [(56, 128), (12, 16)])
def test_chunk_attn_pads_the_head_dim(cuda, D, b):
    """A head dim off the multiples of 16 runs zero-padded (56 -> 64,
    12 -> 16) and returns the plain version's D columns."""
    sh = dict(B=2, Hkv=2, G=3, D=D, b=b, nb=8, m=3)
    for i, ((C, mode), layout, dtype) in enumerate(itertools.product(
            ((1, "latency"), (5, "throughput")), ("ring", "ragged"),
            ("bf16", "int8"))):
        up = upper_of(95 + i, sh["B"], sh["Hkv"], D, 5, "some_dead", cuda)
        for upper in (None, up):
            pre, k, v, q_pos, ks, vs = prelude(95 + i, sh, C, layout, dtype,
                                               cuda, upper=upper)
            compare(pre, k, v, q_pos, sh["m"], ks, vs, True, mode)


@pytest.mark.cuda
def test_chunk_attn_new_shapes_hold_two_blocks_an_sm(cuda):
    """granite (G = 3, D = 64), qwen2-7b (G = 7) and yi-6b (G = 8) at
    4096-token slots: the library's shared memory equals the mirror, and
    both programs fit two blocks an SM in every storage type."""
    lib = chunk_attn._library()
    for (G, D), dt, C, upper in itertools.product(
            ((3, 64), (7, 128), (8, 128)),
            (torch.bfloat16, torch.int8, torch.float32), (1, 128),
            (False, True)):
        c_tile = chunk_attn.tile_width("auto", C, G)
        smem = chunk_attn.smem_bytes(G, c_tile, D, 128, 32, dt)
        assert lib.chunk_attn_smem_bytes(chunk_attn._CACHE_DTYPES[dt], D, 128,
                                         G * c_tile, 32) == smem
        assert chunk_attn.blocks_per_sm(dt, D, 128, upper, smem) >= 2


def bsa_inputs(seed, *, BHKV, G, n, d, b, m, dtype, device, masked=True,
               hot=False, causal=True):
    """Random q/k/v, floor c and m pairs per row: one invalid pair per row,
    causal flags on diagonal pairs (none when not ``causal``), query block 0
    of row 0 unvisited.
    ``hot``: pairs 1 .. nb - 1 of every row are (x, 0) for x = 1 .. nb - 1,
    so key tile 0 walks far more pairs than the rest."""
    r = np.random.default_rng(seed)
    BHG, nb = BHKV * G, n // b

    def dev(x, dt):
        return torch.as_tensor(x, dtype=dt, device=device)

    x = r.integers(0, nb, (BHG, m))
    x[0] = np.where(x[0] == 0, 1 % nb, x[0])
    y = r.integers(0, nb, (BHG, m))
    if hot:
        x[:, 1:nb] = np.arange(1, nb)
        y[:, 1:nb] = 0
    flags = np.ones((BHG, m), np.int32)
    flags[:, -1] = 0
    if causal:
        flags |= 2 * (x == y)
    km = r.integers(0, 2, (BHKV, n)) if masked else np.ones((BHKV, n))
    return (dev(r.standard_normal((BHG, n, d)), dtype),
            dev(r.standard_normal((BHKV, n, d)), dtype),
            dev(r.standard_normal((BHKV, n, d)), dtype),
            dev(r.standard_normal((BHG, nb)), torch.float32),
            dev(x, torch.int32), dev(y, torch.int32), dev(flags, torch.int32),
            dev(km, torch.int32))


def _normalized(out, rs):
    alive = rs > 0
    return torch.where(alive[..., None], out, 0.0) / torch.where(
        alive, rs, 1.0)[..., None]


def _scaled_close(got, want, tol=1e-4):
    s = float(want.abs().max()) or 1.0
    return bool(torch.isclose(got / s, want / s, rtol=tol, atol=tol).all())


BSA_SHAPES = [dict(BHKV=2, G=2, n=64, d=16, b=16, m=6),
              dict(BHKV=2, G=1, n=96, d=12, b=16, m=7),
              dict(BHKV=3, G=2, n=320, d=64, b=64, m=9),
              dict(BHKV=2, G=2, n=512, d=128, b=128, m=8),
              dict(BHKV=4, G=2, n=1024, d=128, b=128, m=24),
              dict(BHKV=2, G=2, n=1024, d=128, b=128, m=16, hot=True),
              dict(BHKV=4, G=3, n=1024, d=64, b=128, m=20),  # granite-moe
              dict(BHKV=2, G=7, n=1024, d=64, b=128, m=20),  # internvl2-1b
              # hubert-xlarge (non-causal), causal, and 72 padded to 80
              dict(BHKV=4, G=1, n=1024, d=80, b=128, m=24, causal=False),
              dict(BHKV=2, G=1, n=512, d=80, b=128, m=8),
              dict(BHKV=2, G=2, n=512, d=72, b=128, m=8),
              # the H-Transformer-1D baseline's (64, 32), non-causal
              dict(BHKV=4, G=1, n=512, d=64, b=32, m=30, causal=False),
              # recurrentgemma-9b's local layers under MRA-2: head dim 256,
              # 16 query heads a KV head; a hot key tile; 248 padded to 256
              dict(BHKV=2, G=16, n=1024, d=256, b=128, m=24),
              dict(BHKV=1, G=4, n=1024, d=256, b=128, m=16, hot=True),
              dict(BHKV=1, G=2, n=512, d=248, b=128, m=8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", BSA_SHAPES,
                         ids=lambda s: "n{n}-d{d}-b{b}-g{G}".format(**s)
                         + ("-hot" if s.get("hot") else "")
                         + ("-noncausal" if s.get("causal") is False else ""))
def test_bsa_kernels_match_plain(cuda, shape, dtype):
    q, k, v, c, x, y, fl, km = bsa_inputs(0, dtype=dtype, device=cuda, **shape)
    b, G, nb = shape["b"], shape["G"], shape["n"] // shape["b"]
    kw = dict(scale=0.3, block_size=b)
    pq = bsa.group_by_query(x, y, fl, nb)
    pk = bsa.group_by_key(x, y, fl, G, nb)
    out, rs, mt = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)
    ref = bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw)
    r = np.random.default_rng(1)
    do = torch.as_tensor(r.standard_normal(tuple(q.shape)), dtype=torch.float32,
                         device=cuda)
    dr = torch.as_tensor(r.standard_normal(tuple(q.shape[:2])),
                         dtype=torch.float32, device=cuda)
    dq = bsa.bsa_bwd_dq(q, k, v, mt, do, dr, pq, km, **kw)
    dk, dv = bsa.bsa_bwd_dkv(q, k, v, mt, do, dr, pk, km, **kw)
    gref = bsa.block_sparse_attention_bwd_ref(q, k, v, c, x, y, fl, km, do, dr,
                                              **kw)
    torch.cuda.synchronize()
    assert torch.equal(rs > 0, ref[1] > 0)
    assert bool(torch.isclose(_normalized(out, rs), _normalized(*ref[:2]),
                              rtol=1e-4, atol=1e-4).all())
    assert bool(torch.isclose(rs, ref[1], rtol=1e-4, atol=1e-4).all())
    assert float((mt - ref[2]).abs().max()) <= 1e-5
    # the unvisited tile: 0 / 0 / c, and dq 0
    assert float(out[0, :b].abs().max()) == 0.0 == float(rs[0, :b].abs().max())
    assert float(dq[0, :b].abs().max()) == 0.0
    assert torch.equal(mt[0, :b], c[0, :1].expand(b))
    for got, want in zip((dq, dk, dv), gref):
        assert _scaled_close(got, want)
    again = (bsa.bsa_fwd(q, k, v, c, pq, km, **kw),
             bsa.bsa_bwd_dq(q, k, v, mt, do, dr, pq, km, **kw),
             bsa.bsa_bwd_dkv(q, k, v, mt, do, dr, pk, km, **kw))
    assert all(torch.equal(a, e) for a, e in zip(again[0], (out, rs, mt)))
    assert torch.equal(again[1], dq)
    assert torch.equal(again[2][0], dk) and torch.equal(again[2][1], dv)


@pytest.mark.cuda
def test_bsa_autograd_function_launches_each_kernel(cuda):
    shape = BSA_SHAPES[0]
    q, k, v, c, x, y, fl, km = bsa_inputs(2, dtype=torch.bfloat16,
                                          device=cuda, **shape)
    before = {n: getattr(bsa, n).launches
              for n in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv")}
    q.requires_grad_(True)
    k.requires_grad_(True)
    out, rs, mt = bsa.block_sparse_attention(q, k, v, c, x, y, fl, km,
                                             scale=0.3, block_size=shape["b"])
    assert not mt.requires_grad
    (out.sum() + rs.sum()).backward()
    assert q.grad.dtype == torch.bfloat16 and v.grad is None
    after = {n: getattr(bsa, n).launches for n in before}
    assert all(after[n] == before[n] + 1 for n in before)


@pytest.mark.cuda
def test_bsa_kernels_reject_bad_input(cuda):
    shape = BSA_SHAPES[0]
    q, k, v, c, x, y, fl, km = bsa_inputs(3, dtype=torch.float32, device=cuda,
                                          **shape)
    nb = shape["n"] // shape["b"]
    pq = bsa.group_by_query(x, y, fl, nb)
    kw = dict(scale=0.3, block_size=shape["b"])
    with pytest.raises(ValueError, match="card"):
        bsa.bsa_fwd(q.cpu(), k.cpu(), v.cpu(), c.cpu(), pq, km.cpu(), **kw)
    with pytest.raises(ValueError, match="dtype"):
        bsa.bsa_fwd(q.half(), k.half(), v.half(), c, pq, km, **kw)
    with pytest.raises(ValueError, match="dtype"):
        bsa.bsa_fwd(q, k.bfloat16(), v, c, pq, km, **kw)
    with pytest.raises(ValueError, match="shape"):
        bsa.bsa_fwd(q, k, v, c[:, :-1].contiguous(), pq, km, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bsa.bsa_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, c,
                    pq, km, **kw)
    with pytest.raises(ValueError, match="block size"):
        bsa.bsa_fwd(q, k, v, c, pq, km, scale=0.3, block_size=256)


@pytest.mark.cuda
@pytest.mark.parametrize("d,b", [(32, 32), (128, 64), (24, 16)])
def test_bsa_kernels_refuse_an_unbuilt_shape_before_launching(cuda, d, b):
    shape = dict(BHKV=1, G=2, n=4 * b, d=d, b=b, m=4)
    q, k, v, c, x, y, fl, km = bsa_inputs(4, dtype=torch.bfloat16, device=cuda,
                                          **shape)
    pq, pk = bsa.group_by_query(x, y, fl, 4), bsa.group_by_key(x, y, fl, 2, 4)
    mt = torch.zeros(q.shape[:2], device=cuda)
    do = torch.zeros(q.shape, device=cuda)
    kw = dict(scale=0.3, block_size=b)
    before = {n: getattr(bsa, n).launches
              for n in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv")}
    with pytest.raises(ValueError, match="is not built"):
        bsa.bsa_fwd(q, k, v, c, pq, km, **kw)
    with pytest.raises(ValueError, match="is not built"):
        bsa.bsa_bwd_dq(q, k, v, mt, do, mt, pq, km, **kw)
    with pytest.raises(ValueError, match="is not built"):
        bsa.bsa_bwd_dkv(q, k, v, mt, do, mt, pk, km, **kw)
    assert before == {n: getattr(bsa, n).launches for n in before}


@pytest.mark.cuda
def test_bsa_plan_mirrors_the_library(cuda):
    lib = bsa._library()
    for (kernel, kid), dt, (D, b) in itertools.product(
            bsa._KERNELS.items(), (torch.bfloat16, torch.float32),
            bsa.KERNEL_SHAPES):
        assert lib.bsa_smem_bytes(kid, bsa._DTYPES[dt], D, b) == \
            bsa.smem_bytes(kernel, dt, D, b)
        assert 1 <= bsa.blocks_per_sm(kernel, dt, D, b) <= \
            bsa.planned_blocks_per_sm(kernel, dt, D, b)
    assert lib.bsa_smem_bytes(0, 0, 32, 32) == 0
    for kernel in ("fwd", "dq", "dkv"):  # the training shapes, bf16
        assert bsa.blocks_per_sm(kernel, torch.bfloat16, 128, 128) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bsa_fwd_granite_shape_matches_plain(cuda, dtype):
    """The forward at (d, b) = (64, 128), G = 3 (granite-moe's whole-prompt
    prefill): the plain twin's normalized numerator, row sums and mt, reruns
    bit-identical, two blocks an SM in bf16; dq and dk/dv (granite-moe's
    training, held in ``test_bsa_kernels_match_plain``) mirror the plan and
    hold two blocks an SM in bf16 too."""
    shape = dict(BHKV=4, G=3, n=1024, d=64, b=128, m=20)
    q, k, v, c, x, y, fl, km = bsa_inputs(5, dtype=dtype, device=cuda, **shape)
    nb = shape["n"] // shape["b"]
    kw = dict(scale=0.125, block_size=shape["b"])
    pq = bsa.group_by_query(x, y, fl, nb)
    before = bsa.bsa_fwd.launches
    out, rs, mt = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)
    again = bsa.bsa_fwd(q, k, v, c, pq, km, **kw)
    ref = bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw)
    torch.cuda.synchronize()
    assert bsa.bsa_fwd.launches == before + 2
    assert all(torch.equal(a, e) for a, e in zip(again, (out, rs, mt)))
    assert torch.equal(rs > 0, ref[1] > 0)
    assert bool(torch.isclose(_normalized(out, rs), _normalized(*ref[:2]),
                              rtol=1e-4, atol=1e-4).all())
    assert bool(torch.isclose(rs, ref[1], rtol=1e-4, atol=1e-4).all())
    assert float((mt - ref[2]).abs().max()) <= 1e-5
    lib = bsa._library()
    assert lib.bsa_smem_bytes(0, bsa._DTYPES[dtype], 64, 128) == \
        bsa.smem_bytes("fwd", dtype, 64, 128)
    assert bsa.blocks_per_sm("fwd", dtype, 64, 128) >= (
        2 if dtype == torch.bfloat16 else 1)
    for kernel in ("dq", "dkv"):  # built there too since MoE training
        assert lib.bsa_smem_bytes(bsa._KERNELS[kernel], bsa._DTYPES[dtype],
                                  64, 128) == bsa.smem_bytes(kernel, dtype,
                                                             64, 128)
        assert bsa.blocks_per_sm(kernel, dtype, 64, 128) >= (
            2 if dtype == torch.bfloat16 else 1)


@pytest.mark.cuda
def test_hubert_head_dim_80_trains_on_the_kernels(cuda):
    """A one-layer hubert at hubert-xlarge's attention shape (head dim 80,
    b = 128, non-causal), seq 512, fp32: loss and every gradient on the
    kernels within 1e-4 of the plain twins' (of the leaf's largest entry),
    each kernel launched once (no remat)."""
    from repro_torch.configs import SHAPES, get_smoke_config
    from repro_torch.core.attention import AttentionSpec
    from repro_torch.data import make_batch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_leaves

    cfg = get_smoke_config(
        "hubert-xlarge", activ_dtype="float32", num_layers=1, head_dim=80,
        d_model=160, num_heads=2, kv_heads=2,
        attention=AttentionSpec(kind="mra2", block_size=128, blocks_per_row=2))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=512,
                                global_batch=2)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, shape, step=0).items()}

    def run(plain):
        params = init_params(cfg, seed=0, device=cuda)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        before = {n: getattr(bsa, n).launches
                  for n in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv")}
        with _plain_bsa() if plain else contextlib.nullcontext():
            loss, _ = transformer.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss, grads, {n: getattr(bsa, n).launches - before[n]
                             for n in before}

    (lk, gk, nk), (lp, gp, npl) = run(False), run(True)
    assert nk == {"bsa_fwd": 1, "bsa_bwd_dq": 1, "bsa_bwd_dkv": 1}
    assert npl == dict.fromkeys(nk, 0)
    assert abs(float(lk.detach()) - float(lp.detach())) <= 1e-4 * abs(
        float(lp.detach()))
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


# ---- speculative serving through the kernel (smoke size, fp32) ------------
def _smoke_engine_case(levels, cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.serve import EngineConfig

    cfg = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
    cfg = cfg.replace(attention=cfg.attention.replace(levels=levels))
    params = init_params(cfg, seed=0, device=cuda)
    if levels == 2:
        return cfg, params, EngineConfig(slots=3, max_len=64, chunk=8), (
            (19, 60), (3, 60), (10, 60), (40, 60), (50, 60))
    return cfg, params, EngineConfig(slots=2, max_len=64, chunk=32), (
        (200, 24), (37, 24), (150, 24), (90, 24))


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [2, 3])
def test_spec_engine_streams_match_the_plain_engine(cuda, levels):
    """Greedy spec_k = 3 on the card: coarse-only drafts (m = 1) and
    (K+1)-chunk verifies through the kernel emit the plain engine's tokens."""
    from repro_torch.serve import Engine, Request

    cfg, params, ecfg, mix = _smoke_engine_case(levels, cuda)
    r = np.random.default_rng(0)
    prompts = [r.integers(0, cfg.vocab, n) for n, _ in mix]

    def run(ec):
        fn = chunk_attn.chunk_attention_kernel
        before = fn.launches + fn.upper_launches
        eng = Engine(cfg, params, ec, device=cuda)
        done = eng.run([Request(prompt=p, max_new_tokens=t)
                        for p, (_, t) in zip(prompts, mix)])
        assert fn.launches + fn.upper_launches > before
        return eng, {len(q.prompt): q.out for q in done}

    _, plain = run(ecfg)
    eng, spec = run(ecfg.replace(spec_k=3))
    assert eng.stats["spec_rounds"] > 0
    for n in plain:
        np.testing.assert_array_equal(spec[n], plain[n])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["h2", "int8", "h3"])
def test_spec_rewind_is_bitwise_on_the_card(cuda, case):
    """snapshot -> 4 coarse draft steps across the ring boundary -> rewind
    leaves every cache tensor (the hierarchy's at H = 3) bitwise as it was."""
    from repro_torch.models import transformer
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.serve.speculative import draft_config

    cfg, params, _, _ = _smoke_engine_case(3 if case == "h3" else 2, cuda)
    cfg = cfg.replace(attention=cfg.attention.replace(kv_quant=case == "int8"))
    eng = Engine(cfg, params, EngineConfig(slots=2, max_len=32, chunk=8),
                 device=cuda)
    eng.run([Request(prompt=np.arange(1, 9), max_new_tokens=23),
             Request(prompt=np.arange(3, 9), max_new_tokens=7)])
    def flat(tree):
        return {(k, i): a.clone() for k, v in tree.items()
                for i, a in enumerate(v if isinstance(v, list) else [v])}

    before = flat(eng.kv.tree)
    act = torch.ones(2, dtype=torch.bool, device=cuda)
    snap = eng.kv.spec_snapshot(5)
    tok = torch.tensor([7, 9], device=cuda)
    for _ in range(4):
        logits, _ = transformer.decode_step(params, draft_config(cfg),
                                            eng.kv.tree, tok, active=act)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)
    assert int(eng.kv.lengths[0]) == 34
    eng.kv.spec_rewind(snap, snap["lengths"], act)
    after = flat(eng.kv.tree)
    for key in before:
        assert torch.equal(after[key], before[key]), key


# ---- the MoE family and the whole-prompt prefill on the card --------------
def _granite_smoke(cuda, **attention):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params

    cfg = get_smoke_config("granite-moe-3b-a800m", activ_dtype="float32")
    if attention:
        cfg = cfg.replace(attention=cfg.attention.replace(**attention))
    return cfg, init_params(cfg, seed=0, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 3])
def test_moe_engine_streams_kernel_vs_plain(cuda, spec_k):
    """granite-moe's smoke config served on the card: greedy streams equal
    with the plain chunk twin substituted, every dispatch launches the
    kernel once a layer (plain engine), and speculation keeps the streams."""
    from unittest import mock

    from repro_torch.serve import Engine, EngineConfig, Request

    cfg, params = _granite_smoke(cuda)
    r = np.random.default_rng(0)
    prompts = [(r.integers(0, cfg.vocab, n), t)
               for n, t in ((19, 60), (3, 4), (10, 9), (40, 6))]
    ecfg = EngineConfig(slots=3, max_len=64, chunk=8, spec_k=spec_k)

    def run(plain):
        fn = chunk_attn.chunk_attention_kernel
        before = fn.launches
        eng = Engine(cfg, params, ecfg, device=cuda)
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(mock.patch.object(
                    chunk_attn, "chunk_attention_kernel",
                    chunk_attn.chunk_attention_ref))
            done = eng.run([Request(prompt=p, max_new_tokens=t)
                            for p, t in prompts])
        return eng, fn.launches - before, {len(q.prompt): q.out for q in done}

    eng, launches, got = run(False)
    _, plain_launches, want = run(True)
    st = eng.stats
    assert plain_launches == 0
    if spec_k == 0:
        assert launches == cfg.num_layers * (st["prefill_dispatches"]
                                             + st["decode_dispatches"])
    else:
        assert st["spec_rounds"] > 0
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_whole_prompt_prefill_matches_prefill_chunk_on_the_card(cuda, quant):
    """granite-moe's smoke config at a budget that covers the prompt (both
    attentions exact): ``prefill`` (the block-sparse forward kernel, once a
    layer) leaves prefill_chunk's cache and last logits; with an int8 cache
    the prefill attends unrounded K/V, so only layer 0's codes are held."""
    from repro_torch.models import transformer
    from repro_torch.serve.cache import RingPagedKVCache

    cfg, params = _granite_smoke(cuda, blocks_per_row=4, decode_blocks=4,
                                 kv_quant=quant)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 48)), device=cuda)
    before = bsa.bsa_fwd.launches
    whole = RingPagedKVCache(cfg, 2, 64, device=cuda).tree
    lw, whole = transformer.prefill(params, cfg, {"tokens": toks}, whole)
    assert bsa.bsa_fwd.launches == before + cfg.num_layers
    chunked = RingPagedKVCache(cfg, 2, 64, device=cuda).tree
    for c0 in range(0, 48, 16):
        lc, chunked = transformer.prefill_chunk(
            params, cfg, chunked, toks[:, c0:c0 + 16],
            torch.full((2,), 16, dtype=torch.int32, device=cuda))
    assert torch.equal(whole["page_blocks"], chunked["page_blocks"])
    assert torch.equal(whole["lengths"], chunked["lengths"])
    layers = 1 if quant else cfg.num_layers
    for key in ("k", "v", "pyr_k", "pyr_v"):
        for i in range(layers):
            a, b = whole[key][i], chunked[key][i]
            if a.dtype == torch.int8:
                assert int((a.int() - b.int()).abs().max()) <= 1, (key, i)
            else:
                tol = 1e-5 * max(1.0, float(b.abs().max()))
                assert float((a - b).abs().max()) <= tol, (key, i)
    if not quant:
        assert float((lw - lc).abs().max()) <= 1e-4


# ---- MoE training through the block-sparse kernels (smoke size, fp32) -----
def _plain_bsa():
    """Patches that route the block-sparse autograd.Function to the plain
    twins on CUDA tensors (here only)."""
    from unittest import mock

    def fwd(q, k, v, c, x, y, fl, km, scale, block_size):
        return (*bsa.block_sparse_attention_ref(
            q, k, v, x, y, fl, c, km, scale=scale, block_size=block_size),
            None)

    def bwd(q, k, v, c, mt, pairs, x, y, fl, km, do, dr, scale, block_size):
        return bsa.block_sparse_attention_bwd_ref(
            q, k, v, c, x, y, fl, km, do, dr, scale=scale,
            block_size=block_size)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(bsa, "_forward", fwd))
    stack.enter_context(mock.patch.object(bsa, "_backward", bwd))
    return stack


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_granite_train_step_kernel_vs_plain(cuda, remat):
    """One ``make_train_step`` step of granite-moe's smoke config (two
    microbatches, bf16 error feedback) on the card: the kernels' loss and
    grad norm within 1e-5 of the plain twins', every kernel launched once a
    layer a microbatch (the forward twice under "dots", which recomputes
    it), and a rerun bitwise equal in loss and grad norm."""
    from repro_torch.configs import SHAPES
    from repro_torch.data import make_batch
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import TrainConfig, make_train_step

    cfg, _ = _granite_smoke(cuda)
    cfg = cfg.replace(remat=remat)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128,
                                global_batch=4)
    tc = TrainConfig(steps=4, microbatches=2, grad_compression="bf16_ef")
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, shape, step=0).items()}

    def step(plain):
        params = init_params(cfg, seed=0, device=cuda)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        fn = make_train_step(cfg, tc, AdamW(), cosine_schedule(1e-3, 1, 4))
        before = {n: getattr(bsa, n).launches
                  for n in ("bsa_fwd", "bsa_bwd_dq", "bsa_bwd_dkv")}
        with _plain_bsa() if plain else contextlib.nullcontext():
            _, _, met = fn(params, AdamW().init(params), batch)
        launches = {n: getattr(bsa, n).launches - before[n] for n in before}
        return float(met["loss"]), float(met["grad_norm"]), launches

    k1, k2, plain = step(False), step(False), step(True)
    calls = cfg.num_layers * tc.microbatches
    assert k1[2] == {"bsa_fwd": calls * (2 if remat == "dots" else 1),
                     "bsa_bwd_dq": calls, "bsa_bwd_dkv": calls}
    assert plain[2] == dict.fromkeys(k1[2], 0)
    assert k1[:2] == k2[:2]
    np.testing.assert_allclose(k1[:2], plain[:2], rtol=1e-5)


@pytest.mark.cuda
def test_plain_block_sparse_twins_rerun_bitwise(cuda):
    """The plain forward and backward sum by block id through a fixed-order
    product (no atomics): reruns on the card are bitwise equal, with many
    pairs landing on each query and key tile."""
    shape = dict(BHKV=4, G=3, n=1024, d=64, b=128, m=40)
    q, k, v, c, x, y, fl, km = bsa_inputs(9, dtype=torch.float32, device=cuda,
                                          **shape)
    kw = dict(scale=0.125, block_size=shape["b"])
    r = np.random.default_rng(2)
    do = torch.as_tensor(r.standard_normal(tuple(q.shape)), dtype=torch.float32,
                         device=cuda)
    dr = torch.as_tensor(r.standard_normal(tuple(q.shape[:2])),
                         dtype=torch.float32, device=cuda)

    def run():
        return (*bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw),
                *bsa.block_sparse_attention_bwd_ref(q, k, v, c, x, y, fl, km,
                                                    do, dr, **kw))

    first = run()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(run(), first))


@pytest.mark.cuda
def test_baselines_on_the_card_equal_the_cpu(cuda):
    from repro_torch.core import baselines

    r = np.random.default_rng(4)
    cpu = [torch.from_numpy(r.standard_normal((1, 4, 256, 64)).astype(
        np.float32)) for _ in range(3)]
    card = [a.to(cuda) for a in cpu]
    for kind, fn in baselines.REGISTRY.items():
        before = bsa.bsa_fwd.launches
        got = fn(*card)
        torch.cuda.synchronize()
        assert bsa.bsa_fwd.launches - before == (kind == "h_transformer_1d")
        want = fn(*cpu)
        assert float((got.cpu() - want).abs().max()) <= 1e-4 * float(
            want.abs().max()), kind


@pytest.mark.cuda
def test_rwkv6_engine_streams_on_the_card_equal_the_cpu(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import (init_params, tree_leaves,
                                           tree_unflatten)
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = get_smoke_config("rwkv6-7b", activ_dtype="float32")
    host = init_params(cfg, seed=0, device="cpu")
    card = tree_unflatten(host, [p.to(cuda) for p in tree_leaves(host)])
    out = {}
    for dev, params in (("cpu", host), ("cuda", card)):
        reqs = [Request(prompt=np.arange(1, n) % cfg.vocab, max_new_tokens=12)
                for n in (40, 17, 3)]
        done = Engine(cfg, params, EngineConfig(slots=2, max_len=16, chunk=8),
                      device=dev).run(reqs)
        out[dev] = {len(q.prompt): np.asarray(q.out) for q in done}
    for n, want in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][n], want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["local", "mra2"])
def test_recurrentgemma_group_served_on_the_card_equals_the_cpu(cuda, kind):
    """One (rglru, rglru, local) group of the recurrentgemma smoke config,
    fp32, served on the card and on the CPU: the same greedy streams, with
    prompts past the 32-token window; under MRA-2 the whole-prompt
    ``prefill`` launches ``bsa_fwd`` once and its last logits equal the
    CPU's within 1e-4 of their largest magnitude."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.attention import AttentionSpec
    from repro_torch.models import recurrentgemma as RG
    from repro_torch.models.params import (init_params, tree_leaves,
                                           tree_unflatten)
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.serve.cache import HybridWindowCache

    cfg = get_smoke_config("recurrentgemma-9b", activ_dtype="float32")
    if kind == "mra2":
        cfg = cfg.replace(attention=AttentionSpec(kind="mra2", block_size=16,
                                                  blocks_per_row=2))
    host = init_params(cfg, seed=0, device="cpu")
    card = tree_unflatten(host, [p.to(cuda) for p in tree_leaves(host)])
    out = {}
    for dev, params in (("cpu", host), ("cuda", card)):
        reqs = [Request(prompt=np.arange(1, n) % cfg.vocab, max_new_tokens=12)
                for n in (70, 33, 5)]
        done = Engine(cfg, params, EngineConfig(slots=2, max_len=64, chunk=16),
                      device=dev).run(reqs)
        out[dev] = {len(q.prompt): np.asarray(q.out) for q in done}
    for n, want in out["cpu"].items():
        np.testing.assert_array_equal(out["cuda"][n], want)
    if kind == "mra2":
        toks = torch.from_numpy(np.arange(1, 129, dtype=np.int32)[None] % 500)
        got = {}
        for dev, params in (("cpu", host), ("cuda", card)):
            before = bsa.bsa_fwd.launches
            with torch.no_grad():
                logits, _ = RG.prefill(params, cfg, {"tokens": toks.to(dev)},
                                       HybridWindowCache(cfg, RG, 1, 128,
                                                         device=dev).tree)
            got[dev] = (logits.float().cpu(), bsa.bsa_fwd.launches - before)
        assert got["cuda"][1] == 1 and got["cpu"][1] == 0
        want = got["cpu"][0]
        assert float((got["cuda"][0] - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


@pytest.mark.cuda
def test_sharded_attention_routes_on_a_1x2_mesh_equal_the_one_device_slice(
        cuda):
    """Two ranks on the one card (gloo, a (1, 2) mesh: the kv heads split
    over "model", the batch over a data axis of one): the block-sparse kernels (MRA-2 self-attention, forward
    and gradients) and the chunk kernel (chunk and decode over a ring page
    table with int8 scales, both modes) on each rank's (batch, kv-head)
    block equal the same slice of the one-device kernel call (same
    tolerances as the kernels against their plain twins)."""
    import torch_dist_ranks as R
    from repro_torch.core.attention import (
        AttentionSpec,
        chunk_attention,
        decode_attention,
        self_attention,
    )
    from repro_torch.distributed.sharding import attention_pspec, local_block
    from repro_torch.launch.mesh import spawn

    r = np.random.default_rng(0)
    B, Hq, Hkv, N, D, b = 2, 4, 2, 64, 16, 16
    q = r.standard_normal((B, Hq, N, D)).astype(np.float32)
    k = r.standard_normal((B, Hkv, N, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, N, D)).astype(np.float32)
    masks = [np.ones((B, N), bool), r.random((B, N)) > 0.25]
    S, C, nb = 64, 8, 4
    lengths = np.array([37, 64], np.int32)
    kv = dict(k=k, v=v, q=r.standard_normal((B, Hq, C, D)).astype(np.float32),
              q1=r.standard_normal((B, Hq, 1, D)).astype(np.float32),
              lengths=lengths,
              q_pos=(np.maximum(lengths[:, None] - C, 0)
                     + np.arange(C)).astype(np.int32),
              lengths_ring=np.array([96, 20], np.int32),
              pb=np.stack([np.roll(np.arange(nb) + nb // 2, nb // 2),
                           np.arange(nb)]).astype(np.int32))
    kq, ks = (x.numpy() for x in tmd.quantize_kv(torch.from_numpy(k)))
    vq, vs = (x.numpy() for x in tmd.quantize_kv(torch.from_numpy(v)))
    kv.update(kq=kq, ks=ks, vq=vq, vs=vs)
    cases = [("attention", dict(mesh_shape=(1, 2), q=q, k=k, v=v, masks=masks,
                                block_size=b, blocks_per_row=2,
                                device="cuda")),
             ("kv_routes", dict(mesh_shape=(1, 2), block_size=b,
                                decode_blocks=2, device="cuda", **kv))]
    got = spawn(R.run_cases, 2, cases, device="cuda", timeout=600)

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    spec = AttentionSpec(kind="mra2", block_size=b, blocks_per_row=2)
    want_attn = []
    for causal in (False, True):
        for km in masks:
            ts = [T(x).requires_grad_() for x in (q, k, v)]
            o = self_attention(*ts, spec, causal=causal, key_mask=T(km))
            grads = torch.autograd.grad(torch.tanh(o).sum(), ts)
            want_attn.append((o.detach().cpu(), [g.cpu() for g in grads]))
    want_kv = {}
    for mode in ("latency", "throughput"):
        sp = AttentionSpec(kind="mra2", block_size=b, decode_blocks=2,
                           kernel_mode=mode)
        c = chunk_attention(T(kv["q"]), T(k), T(v), T(lengths), T(kv["q_pos"]),
                            sp)
        d = decode_attention(T(kv["q1"]), T(kq), T(vq), T(kv["lengths_ring"]),
                             sp, page_blocks=T(kv["pb"]), k_scale=T(ks),
                             v_scale=T(vs))
        want_kv[mode] = (c.cpu(), d.cpu())

    class Mesh:
        shape = {"data": 1, "model": 2}

        def __init__(self, m):
            self.m = m

        def index(self, axis):
            return self.m if axis == "model" else 0

    for rank, res in enumerate(got):
        mesh = Mesh(rank)
        a, c = res["attention"], res["kv_routes"]
        assert a["parts"] == c["parts"] == ("data", "model")
        assert a["launches"]["bsa_fwd"] == 4 and a["launches"]["bsa_bwd_dq"] == 4
        assert c["launches"]["chunk_attn"] == 4

        def blk(t):
            return local_block(t, attention_pspec(a["parts"], t.dim()),
                               mesh).numpy()

        for (o, grads), (wo, wg) in zip(a["out"], want_attn):
            np.testing.assert_allclose(o, blk(wo), rtol=1e-4, atol=1e-4)
            for g, w in zip(grads, wg):
                np.testing.assert_allclose(g, blk(w), rtol=1e-4, atol=1e-4)
        for mode, (wc, wd) in want_kv.items():
            cg, dg = c["out"][mode]
            np.testing.assert_allclose(cg, blk(wc), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(dg, blk(wd), rtol=RTOL, atol=ATOL)
