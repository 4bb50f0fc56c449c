"""The serving kernel's shapes of the reference's cells, on the CPU.

Two halves:

* the plan (``chunk_attn.plan``): every (G, C, nb) that the four shape
  cells give each MRA preset plans a tile that launches — the shared-memory
  program where its page arrays fit a block (every shape that launched
  before keeps it), the workspace program past that, whose shared memory no
  longer grows with the page count, for the two-level and the H-level
  program alike; head dim 80 (hubert-xlarge) takes one m16 row tile (16
  query rows), kimi-k2's head dim 112 four warps of 32 columns with the
  last one's ending at 112 (two m16 row tiles);
* the arithmetic at hubert's serving shape (16 KV heads of one query head,
  head dim 80, block 128): the port's chunk / decode attention on the CPU
  (the kernel wrapper's plain twin) against the reference's jnp route on
  the same numpy inputs, fp32 and bf16 caches, at the serving tolerance
  (atol 2e-5 / rtol 1e-5); and the H-level plain twin at kimi-k2's head dim
  112 likewise. The CUDA kernel against that twin runs on the card
  (``chip_smoke.py`` phases 40-41 and 46-47).
"""
from __future__ import annotations

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mra_decode as jmd
from repro.core.mra import MraConfig as JMraConfig
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.core import mra_decode as tmd
from repro_torch.core.mra import MraConfig
from repro_torch.kernels import chunk_attn
from test_chunk_kernel import Case, make_case_inputs

ATOL, RTOL = 2e-5, 1e-5
MRA_DECODERS = [a for a in ARCHS
                if get_config(a).attention.kind in ("mra2", "mra2_s")
                and get_config(a).family not in ("rwkv6", "recurrentgemma")]
CHUNKS = (1, 5, 128, 512)  # decode, a verify, the engine's prefill chunks
DTYPES = (torch.bfloat16, torch.int8, torch.float32)


def _serving_shape(arch):
    cfg = get_config(arch)
    G = cfg.num_heads // cfg.kv_heads
    return G, chunk_attn.padded_dim(cfg.hd), cfg.attention.block_size


@pytest.mark.parametrize("cell", [s for s in SHAPES if s != "train_4k"])
@pytest.mark.parametrize("arch", MRA_DECODERS)
def test_every_cell_plans_a_tile_that_launches(arch, cell):
    G, D, b = _serving_shape(arch)
    nb = SHAPES[cell].seq_len // b
    B = SHAPES[cell].global_batch
    assert (D, b) in chunk_attn.KERNEL_SHAPES  # every served shape is built
    for C, dt in itertools.product(CHUNKS, DTYPES):
        geo = chunk_attn.plan(B, get_config(arch).kv_heads, G, C, D, b, nb,
                              dt, sms=132)
        shared = chunk_attn.smem_bytes(G, geo["c_tile"], D, b, nb, dt)
        assert geo["smem"] <= chunk_attn._MAX_SMEM
        assert geo["workspace"] == (shared > chunk_attn._MAX_SMEM)
        assert geo["rows"] <= chunk_attn.tile_rows(D)
        if geo["workspace"]:
            assert geo["ws_bytes"] == (
                B * get_config(arch).kv_heads * geo["tiles"] * geo["nsplit"]
                * chunk_attn.workspace_bytes(geo["rows"], nb))
            assert geo["smem"] == chunk_attn.smem_bytes(
                G, geo["c_tile"], D, b, 1, dt, workspace=True)


@pytest.mark.parametrize("dt", DTYPES)
def test_workspace_program_only_past_the_shared_layout(dt):
    """qwen3-1.7b (G = 2) at 4096-token slots keeps the shared-memory
    program for decode and C = 128 (every shape that launched before); at
    long_500k's 4096 pages a C = 128 tile takes the workspace program, its
    shared memory the same at any page count; a decode of G = 7 (qwen2-7b)
    at 4096 pages likewise."""
    for C, nb in ((1, 32), (128, 32), (1, 256), (128, 256)):
        assert not chunk_attn.plan(4, 8, 2, C, 128, 128, nb, dt)["workspace"]
    geo = chunk_attn.plan(1, 8, 2, 128, 128, 128, 4096, dt)
    assert geo["workspace"] and geo["smem"] <= 113 * 1024
    assert geo["smem"] == chunk_attn.plan(1, 8, 2, 128, 128, 128, 65536,
                                          dt)["smem"]
    assert chunk_attn.plan(1, 4, 7, 1, 128, 128, 4096, dt)["workspace"] == (
        chunk_attn.smem_bytes(7, 1, 128, 128, 4096, dt) > chunk_attn._MAX_SMEM)
    assert chunk_attn.workspace_bytes(16, 4096) == 2 * 16 * 4096 * 4 + (
        16 * 4096) + 4096 + 4096 * 4
    # the workspace program is built for both programs at block 128: the
    # H-level one takes it past shared memory too; the smoke shape refuses
    assert not chunk_attn.plan(1, 8, 2, 128, 128, 128, 32, dt,
                               upper=True)["workspace"]
    assert chunk_attn.plan(1, 8, 2, 128, 128, 128, 4096, dt,
                           upper=True)["workspace"]
    with pytest.raises(ValueError, match="workspace program is built"):
        chunk_attn.plan(1, 2, 2, 128, 16, 16, 4096, dt)


# the H-level shapes that needed more than shared memory: qwen2-7b's G = 7
# C = 128 chunk at a 512-page ring, qwen3-1.7b's C = 128 chunk at 1000
# pages and its decode at 6448 pages
UPPER_PAST_SMEM = ((1, 8, 7, 128, 512), (1, 8, 2, 128, 1000),
                   (1, 8, 2, 1, 6448))


@pytest.mark.parametrize("B,Hkv,G,C,nb", UPPER_PAST_SMEM)
@pytest.mark.parametrize("dt", DTYPES)
def test_upper_program_plans_the_workspace_past_shared_memory(dt, B, Hkv, G,
                                                              C, nb):
    """The H-level program at shapes whose bf16 page arrays pass the
    232,448 bytes a block may use plans the workspace program, with one
    slice of ``workspace_bytes`` a block (int8 and fp32, whose ring stages
    are smaller, take it wherever their shared layout does not fit), and
    the same plan as the two-level one."""
    geo = chunk_attn.plan(B, Hkv, G, C, 128, 128, nb, dt, upper=True)
    shared = chunk_attn.smem_bytes(G, geo["c_tile"], 128, 128, nb, dt)
    assert geo["workspace"] == (shared > chunk_attn._MAX_SMEM)
    assert geo["workspace"] or dt != torch.bfloat16
    assert geo["smem"] <= chunk_attn._MAX_SMEM
    assert geo["ws_bytes"] == (
        B * Hkv * geo["tiles"] * geo["nsplit"]
        * chunk_attn.workspace_bytes(geo["rows"], nb) if geo["workspace"]
        else 0)
    assert geo["smem"] == chunk_attn.smem_bytes(
        G, geo["c_tile"], 128, 128, nb, dt, workspace=geo["workspace"])
    assert geo == chunk_attn.plan(B, Hkv, G, C, 128, 128, nb, dt)


def test_head_dim_112_is_built_at_one_row_tile():
    """kimi-k2's (112, 128): four warps own 32 columns each, the last one's
    ending at 112 (its k-step and n-tiles past 112 skipped), and a tile
    holds one m16 row tile (two spilled); a bf16 row is 14 chunks padded to
    15, an int8 one 7 (odd), an fp32 one 28 padded to 29."""
    chunk_attn.check_shape(112, 128)
    assert chunk_attn.warp_columns(112) == (4, 32)
    assert chunk_attn.warp_columns(128) == (4, 32)
    assert chunk_attn.warp_columns(64) == (2, 32)
    assert chunk_attn.warp_columns(16) == (1, 16)
    assert chunk_attn.tile_rows(112) == 16
    assert chunk_attn.tile_rows(128) == chunk_attn.tile_rows(64) == 32
    assert chunk_attn.tile_width("auto", 128, 8, 112) == 2  # kimi-k2's G = 8
    assert [chunk_attn.row_stride(112 * s) for s in (2, 1, 4)] == [240, 112,
                                                                   464]
    # a decode tile of G = 8 rows at 32 pages: the ring of two 64-key K + V
    # stages, the exchange of four warps over 16 rows, the page arrays
    smem = chunk_attn.smem_bytes(8, 1, 112, 128, 32, torch.bfloat16)
    assert smem == (2 * 2 * 64 * 240 + 4 * 16 * 72 * 4 + 2 * 8 * 32 * 4
                    + 8 * 32 + 32 + 32 * 4 + 3 * 16 * 4 + 16)
    assert chunk_attn.plan(4, 8, 8, 1, 112, 128, 32, torch.bfloat16)[
        "smem"] == smem


def test_head_dim_80_is_built_at_one_row_tile():
    """hubert-xlarge's (80, 128): one warp owns all 80 columns (32 does not
    divide 80), so a tile holds one m16 row tile; staged rows are padded to
    an odd count of 16-byte chunks (ChunkRow)."""
    chunk_attn.check_shape(80, 128)
    assert chunk_attn.warp_columns(80) == (1, 80)
    assert chunk_attn.tile_rows(80) == 16 and chunk_attn.tile_rows(128) == 32
    assert chunk_attn.tile_width("auto", 128, 1, 80) == 8
    assert chunk_attn.tile_width("auto", 128, 2, 80) == 8
    assert chunk_attn.tile_width("auto", 128, 4, 80) == 4
    with pytest.raises(ValueError, match="16 rows a tile"):
        chunk_attn.tile_width("auto", 1, 17, 80)
    # bf16 rows of 80: ten chunks in a row of eleven; int8: five (odd);
    # fp32: twenty in twenty-one; power-of-two counts keep their width
    assert [chunk_attn.row_stride(80 * s) for s in (2, 1, 4)] == [176, 80, 336]
    assert [chunk_attn.row_stride(128 * s) for s in (2, 1, 4)] == [256, 128,
                                                                   512]
    # a C = 128 tile of 8 rows at 32 pages: the two-slot ring of 64-key
    # stages of K and V, 8 x 32 page arrays, the per-row scalars of 16 rows
    smem = chunk_attn.smem_bytes(1, 8, 80, 128, 32, torch.bfloat16)
    assert smem == (2 * 2 * 64 * 176 + 2 * 8 * 32 * 4 + 8 * 32 + 32
                    + 32 * 4 + 3 * 16 * 4 + 16)
    assert smem <= 113 * 1024


# --------------------------------------------------------------------------- #
# hubert's serving shape: the plain twin against the reference's jnp route
# --------------------------------------------------------------------------- #
HUBERT = Case(B=2, Hkv=16, group=1, D=80, b=128, S=1024, m=3, seed=5)


def _run(case, C, cache_dtype, decode, paged):
    case = dataclasses.replace(case, paged=paged)
    q, k, v, lengths, q_pos, pb, ks, vs = make_case_inputs(case, C=C)
    if cache_dtype == "bf16":
        k, v = (jnp.asarray(x, jnp.bfloat16) for x in (k, v))
    jcfg = JMraConfig(block_size=case.b, causal=True)
    tcfg = MraConfig(block_size=case.b)

    def T(x):
        if x is None:
            return None
        a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t

    kw = dict(decode_blocks=case.m, page_blocks=pb)
    if decode:
        ref = jmd.mra2_decode_attention(q, k, v, lengths, jcfg, **kw)
        got = tmd.mra2_decode_attention(T(q), T(k), T(v), T(lengths), tcfg,
                                        decode_blocks=case.m, page_blocks=T(pb))
    else:
        ref = jmd.mra2_chunk_attention(q, k, v, lengths, q_pos, jcfg, **kw)
        got = tmd.mra2_chunk_attention(T(q), T(k), T(v), T(lengths), T(q_pos),
                                       tcfg, decode_blocks=case.m,
                                       page_blocks=T(pb))
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "ring"])
@pytest.mark.parametrize("cache_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["decode", "chunk128"])
def test_hubert_serving_shape_matches_jax(mode, cache_dtype, paged):
    got, ref = _run(HUBERT, 1 if mode == "decode" else 128, cache_dtype,
                    mode == "decode", paged)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


# kimi-k2's serving shape cut to two KV heads of its eight query heads each:
# head dim 112 at block 128, eight pages
KIMI = Case(B=2, Hkv=2, group=8, D=112, b=128, S=1024, m=3, seed=9)


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("C", [1, 8])
def test_kimi_upper_plain_twin_matches_jax(C, cache_dtype):
    """The H-level plain twin at head dim 112 (a live, a dead and the tail
    entry of a collapsed view) against the reference's jnp route, on the
    ring layout."""
    from test_torch_hier import _hier_both

    case = dataclasses.replace(KIMI, paged=True,
                               quant=cache_dtype == "int8")
    got, ref, _, _ = _hier_both(case, C, "some_dead", cache_dtype)
    assert got.shape == ref.shape == (2, 16, C, 112)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
