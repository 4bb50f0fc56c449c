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
  * ``bsa_fwd`` / ``bsa_bwd_dq`` / ``bsa_bwd_dkv`` against
    ``block_sparse_attention_ref`` / ``_bwd_ref``: the normalized numerator
    and the max-scaled gradients at rtol/atol 1e-4, mt at abs 1e-5 (fp32
    sums in another order, split bf16 operands on tensor cores); reruns
    bit-identical; bf16 and fp32 (every operand split) at every built
    (d, b), a padded head dim and a hot key tile; an unbuilt (d, b) is
    refused before any launch; the plan mirrors the library.
"""
from __future__ import annotations

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
    q, k, v, lengths, q_pos, pb, ks, vs = make_inputs(
        0, B=2, Hkv=2, G=2, D=8, b=16, nb=4, C=1, layout="dense",
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


def bsa_inputs(seed, *, BHKV, G, n, d, b, m, dtype, device, masked=True,
               hot=False):
    """Random q/k/v, floor c and m pairs per row: one invalid pair per row,
    causal flags on diagonal pairs, query block 0 of row 0 unvisited.
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
              dict(BHKV=2, G=2, n=1024, d=128, b=128, m=16, hot=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", BSA_SHAPES,
                         ids=lambda s: "n{n}-d{d}-b{b}-g{G}".format(**s)
                         + ("-hot" if s.get("hot") else ""))
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
