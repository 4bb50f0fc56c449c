"""CUDA kernels of repro_torch on the card, held against their plain versions.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs are made with numpy from a seed. The kernel and its plain twin
(``chunk_attention_ref``) run on the same CUDA tensors; outputs must agree
at atol 2e-5 / rtol 1e-5 (fp32 sums in another order) on every row whose
top-m selection is not a near tie (gap between the m-th and (m+1)-th
allowed coarse score >= 1e-4), and near ties must stay under 1% of rows —
the kernel's fused multiply-adds may break such a tie the other way.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from repro_torch.core import mra_decode as tmd
from repro_torch.core.mra import MraConfig
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
    else:
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


def compare(pre, k, v, q_pos, m, ks, vs, include_bg, mode):
    """(max |err| over non-tie rows, near-tie rows, rows) of kernel vs plain."""
    kw = dict(m=m, k_scale=ks, v_scale=vs, include_bg=include_bg, mode=mode)
    got = chunk_attn.chunk_attention_kernel(pre, k, v, q_pos, **kw)
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
