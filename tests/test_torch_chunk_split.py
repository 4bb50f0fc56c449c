"""The split decode of the chunk kernel and its split operands, on the CPU.

The CUDA kernel (``csrc/chunk_attn.cu``) cannot run here, so this file holds
what surrounds it to the plain route, with numpy inputs from a seed:

  * ``split_plan``: the page ranges cover every page exactly once; chunked
    prefill at the served shapes does not split; decode splits to the
    largest grid within one wave of two blocks per SM of an H100 (132
    SMs), and within one block per SM where shared memory holds one;
  * the three-term bf16 split of an fp32 operand recomposes it exactly, and
    products from the terms match fp32 (within 1e-6 of the largest |q·k|)
    against bf16 keys, int8 codes and (six products) fp32 keys;
  * ``chunk_attention_split_ref`` — the plain version of the split blocks
    and their combine — equals ``chunk_attention_ref`` at atol 1e-6 (the
    same sums, rescaled once more) over the reference sweep
    ``tests/test_chunk_kernel.py::SWEEP`` (MRA-2 and MRA-2-s, int8, ring and
    ragged layouts), with H-level views of NU = 5 and 40 entries, and with
    splits that get no page;
  * ``smem_bytes`` stays within 113 KB (two blocks an SM) and a tile within
    ``MAX_TILE_ROWS`` rows at the qwen3-1.7b, llama3.2-3b, granite-moe
    (D = 64), qwen2-7b (G = 7) and yi-6b (G = 8) shapes for every storage
    type; the wrappers refuse a (head dim, block size) a kernel is not
    built for (kimi-k2's (112, 128); granite's (64, 128) for the
    block-sparse backward); zero-padding a head dim to a multiple of 16 is
    exact for the plain version.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import mra_decode as tmd
from repro_torch.core.hier import HierUpper
from repro_torch.core.mra import MraConfig
from repro_torch.kernels import chunk_attn
from repro_torch.kernels.split import bf16_terms
from test_chunk_kernel import SWEEP, Case, make_case_inputs
from test_torch_mra_decode import T, _dequant_pyramid

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_TARGET = 113 * 1024  # per block, so that two blocks share an SM


# --------------------------------------------------------------------------- #
# split plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("nb", [1, 3, 4, 20, 24, 32, 256])
def test_split_ranges_cover_every_page_once(nb):
    for nsplit in range(1, nb + 1):
        ranges = chunk_attn.split_ranges(nb, nsplit)
        assert len(ranges) == nsplit
        pages = [j for p0, p1 in ranges for j in range(p0, p1)]
        assert pages == list(range(nb))
        sizes = {p1 - p0 for p0, p1 in ranges}
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("arch,B,C", [("qwen3-1.7b", 4, 128),
                                      ("qwen3-1.7b", 2, 512),
                                      ("llama3.2-3b", 4, 128),
                                      ("granite-moe-3b-a800m", 4, 128),
                                      ("qwen2-7b", 4, 128), ("yi-6b", 4, 128)])
def test_split_plan_leaves_chunked_prefill_whole(arch, B, C):
    cfg = get_config(arch)
    G = cfg.num_heads // cfg.kv_heads
    tiles = -(-C // chunk_attn.tile_width("auto", C, G))
    nsplit, ranges = chunk_attn.split_plan(B, cfg.kv_heads, tiles, 32, SMS)
    assert nsplit == 1 and ranges == [(0, 32)]


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama3.2-3b",
                                  "granite-moe-3b-a800m"])
def test_split_plan_fills_the_card_at_decode(arch, B):
    cfg = get_config(arch)
    nb = 4096 // cfg.attention.block_size
    for per_sm in (2, 1):
        nsplit, ranges = chunk_attn.split_plan(B, cfg.kv_heads, 1, nb, SMS,
                                               per_sm)
        blocks = B * cfg.kv_heads * nsplit
        assert blocks <= per_sm * SMS  # one wave of resident blocks
        assert nsplit & (nsplit - 1) == 0 and nsplit <= nb
        assert 2 * blocks > per_sm * SMS  # the largest such count
        assert ([j for p0, p1 in ranges for j in range(p0, p1)]
                == list(range(nb)))


# --------------------------------------------------------------------------- #
# split operands
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0, 3e4])
def test_bf16_terms_recompose_fp32_exactly(scale):
    r = np.random.default_rng(0)
    x = torch.from_numpy((r.standard_normal(4096) * scale).astype(np.float32))
    t0, t1, t2 = bf16_terms(x)
    assert torch.equal((t0.float() + t1.float()) + t2.float(), x)
    assert bool((t1.float().abs() <= t0.float().abs() * 2 ** -8).all())


@pytest.mark.parametrize("keys", ["bf16", "int8", "fp32"])
def test_products_of_terms_match_fp32(keys):
    """q·k from the terms (the kernel's product set) against the exact
    product, within 1e-6 of the largest |q·k|: three products against bf16
    keys or int8 codes, six (terms i + j <= 2) against split fp32 keys."""
    r = np.random.default_rng(1)
    q = torch.from_numpy(r.standard_normal((16, 128)).astype(np.float32))
    kf = torch.from_numpy(r.standard_normal((64, 128)).astype(np.float32))
    if keys == "bf16":
        k_terms = [kf.to(torch.bfloat16)]
    elif keys == "int8":
        k_terms = [tmd.quantize_kv(kf[None])[0][0].to(torch.bfloat16)]
    else:
        k_terms = list(bf16_terms(kf))
    k = sum(t.double() for t in k_terms)
    exact = q.double() @ k.T
    got = torch.zeros(16, 64)
    for i, qi in enumerate(bf16_terms(q)):
        for j, kj in enumerate(k_terms):
            if i + j <= 2:
                got = got + qi.float() @ kj.float().T
    err = float((got.double() - exact).abs().max() / exact.abs().max())
    assert err <= 1e-6


# --------------------------------------------------------------------------- #
# the plain split-and-combine
# --------------------------------------------------------------------------- #
def _prelude(case: Case, C: int, upper=None):
    q, k, v, lengths, q_pos, pb, ks, vs = make_case_inputs(case, C=C)
    pyr = None
    if ks is not None:  # the engine's dequantized pyramid (ROADMAP queue 3)
        pyr = tmd.PyramidState(*(T(x) for x in _dequant_pyramid(
            case, (q, k, v, lengths, q_pos, pb, ks, vs))))
    if upper is not None:
        pyr = (pyr or _pyramid(case, k, v, lengths, pb))._replace(upper=upper)
    cfg = MraConfig(block_size=case.b, variant=case.variant)
    m = 1 if case.coarse_only else case.m
    pre = tmd._chunk_prelude(T(q), T(k), T(v), T(lengths), T(q_pos), cfg, m,
                             pyr, None if pb is None else T(pb))
    return pre, T(k), T(v), T(q_pos), T(ks), T(vs), m


def _pyramid(case, k, v, lengths, pb):
    nb = case.S // case.b
    pbt = T(pb) if pb is not None else tmd.identity_page_table(case.B, nb)
    mask = tmd.paged_position_mask(T(lengths), pbt, case.S, case.b).float()
    sums = [(T(x) * mask[:, None, :, None]).reshape(
        case.B, case.Hkv, nb, case.b, case.D).sum(3) for x in (k, v)]
    return tmd.PyramidState(*sums)


def _both(pre, k, v, q_pos, ks, vs, m, include_bg, nsplit):
    kw = dict(m=m, k_scale=ks, v_scale=vs, include_bg=include_bg)
    return (chunk_attn.chunk_attention_split_ref(pre, k, v, q_pos,
                                                 nsplit=nsplit, **kw),
            chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw))


@pytest.mark.parametrize("nsplit", [1, 2, 4])
@pytest.mark.parametrize("C", [1, 8])
@pytest.mark.parametrize("case", SWEEP, ids=lambda c: c.id)
def test_split_combine_equals_plain_over_the_sweep(case, C, nsplit):
    pre, k, v, q_pos, ks, vs, m = _prelude(case, C)
    got, ref = _both(pre, k, v, q_pos, ks, vs, m, case.variant == "full",
                     nsplit)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


def test_sweep_has_splits_that_get_no_page():
    """The sweep's coarse-only and ragged cases leave some of four splits
    without a selected page (and an empty slot without any)."""
    empty = 0
    for case in SWEEP:
        pre, k, v, q_pos, ks, vs, m = _prelude(case, 1)
        sel = tmd._select_pages(pre, T(np.asarray(q_pos)), m)
        grid = torch.zeros(sel.coarse_m.shape, dtype=torch.bool).scatter_(
            -1, sel.y_idx, sel.sel_ok)
        union = grid.any(3).any(2)  # (B, Hkv, nb)
        for p0, p1 in chunk_attn.split_ranges(union.shape[-1], 4):
            empty += int((~union[..., p0:p1].any(-1)).sum())
    assert empty > 0


def _upper(seed, B, Hkv, D, nu, pattern):
    r = np.random.default_rng(seed)
    km = r.standard_normal((B, Hkv, nu, D)).astype(np.float32)
    km[:, :, 1:3] *= 3.0
    vm = r.standard_normal((B, Hkv, nu, D)).astype(np.float32)
    cnt = r.integers(1, 257, (B, nu)).astype(np.float32)
    if pattern == "some_dead":
        cnt[:, ::2] = 0.0
    elif pattern == "tail_only":
        cnt[:, :-1] = 0.0
    return HierUpper(T(km), T(vm), T(cnt))


@pytest.mark.parametrize("nsplit", [1, 2, 4])
@pytest.mark.parametrize("nu,pattern", list(itertools.product(
    (5, 40), ("all_live", "some_dead", "tail_only"))))
def test_split_combine_with_an_upper_view(nu, pattern, nsplit):
    for i, (layout, quant) in enumerate(itertools.product(
            ("paged", "ragged"), (False, True))):
        case = Case(group=2, quant=quant, seed=70 + i, **{layout: True})
        up = _upper(i, case.B, case.Hkv, case.D, nu, pattern)
        for C in (1, 8):
            pre, k, v, q_pos, ks, vs, m = _prelude(case, C, up)
            got, ref = _both(pre, k, v, q_pos, ks, vs, m, True, nsplit)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{layout} C={C}")


# --------------------------------------------------------------------------- #
# shared memory and the shapes the kernel is built for
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama3.2-3b",
                                  "granite-moe-3b-a800m", "qwen2-7b", "yi-6b"])
def test_smem_fits_two_blocks_per_sm(arch, dtype):
    """G = 2 / 3 (qwen3, llama, granite at D = 64) and 7 / 8 (qwen2-7b,
    yi-6b): every tile within MAX_TILE_ROWS rows and 113 KB."""
    cfg = get_config(arch)
    G = cfg.num_heads // cfg.kv_heads
    D, b = cfg.head_dim, cfg.attention.block_size
    chunk_attn.check_shape(D, b)
    for C in (1, 5, 128, 512):
        c_tile = chunk_attn.tile_width("auto", C, G)
        assert G * c_tile <= chunk_attn.MAX_TILE_ROWS, (C, c_tile)
        smem = chunk_attn.smem_bytes(G, c_tile, D, b, 4096 // b, dtype)
        assert smem <= SMEM_TARGET, (C, smem)


def test_tile_width_keeps_32_rows_and_refuses_unbuilt_shapes():
    assert chunk_attn.tile_width("auto", 1, 3) == 1
    assert chunk_attn.tile_width("auto", 128, 3) == 8
    assert chunk_attn.tile_width("throughput", 5, 2) == 5
    assert chunk_attn.tile_width("throughput", 128, 8) == 4
    with pytest.raises(ValueError, match="rows a tile"):
        chunk_attn.tile_width("auto", 1, 33)
    for D, b in chunk_attn.KERNEL_SHAPES:
        chunk_attn.check_shape(D, b)
    with pytest.raises(ValueError, match=r"\(128, 128\), \(16, 16\)"):
        chunk_attn.check_shape(8, 16)


def test_unbuilt_head_dims_are_refused_by_name():
    """(96, 128), a head dim no served model has, is built for neither
    kernel; granite's (64, 128) and kimi-k2's (112, 128) for both. Each
    refusal is a ValueError naming the shape."""
    from repro_torch.kernels import block_sparse_attn as bsa

    with pytest.raises(ValueError, match=r"\(96, 128\)"):
        chunk_attn.check_shape(96, 128)
    chunk_attn.check_shape(chunk_attn.padded_dim(56), 128)
    chunk_attn.check_shape(112, 128)
    with pytest.raises(ValueError, match=r"\(96, 128\) is not built"):
        bsa.check_shape(96, 128)
    bsa.check_shape(64, 128)
    bsa.check_shape(112, 128)
    for kernel in ("fwd", "dq", "dkv"):
        assert bsa.kernel_plan(kernel, torch.bfloat16, 64, 128)[
            "sub_tiles"] == 2
    with pytest.raises(ValueError, match="is not built"):
        bsa.kernel_plan("dq", torch.bfloat16, 96, 128)


@pytest.mark.parametrize("D,b", [(56, 128), (12, 16)])
@pytest.mark.parametrize("quant", [False, True])
def test_padded_head_dim_is_exact_for_the_plain_version(D, b, quant):
    """What the CUDA wrapper launches for a head dim off the multiples of 16
    (``pad_head_dim``: queries, page and collapsed means and cache rows
    zero-padded to 64 / 16) gives the unpadded plain result on the first D
    columns and zeros after them, with and without an H-level view."""
    case = Case(B=2, Hkv=2, S=4 * b, D=D, b=b, m=2, group=3, quant=quant,
                paged=True, seed=7)
    for C in (1, 5):
        for up in (None, _upper(8, 2, 2, D, 5, "some_dead")):
            pre, k, v, q_pos, ks, vs, m = _prelude(case, C, up)
            kw = dict(m=m, k_scale=ks, v_scale=vs)
            want = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, **kw)
            ppre, pk, pv = chunk_attn.pad_head_dim(pre, k, v)
            assert ppre.qg.shape[-1] == pk.shape[-1] == chunk_attn.padded_dim(D)
            got = chunk_attn.chunk_attention_ref(ppre, pk, pv, q_pos, **kw)
            np.testing.assert_allclose(got[..., :D].numpy(), want.numpy(),
                                       atol=1e-6, rtol=0)
            assert not got[..., D:].any()
