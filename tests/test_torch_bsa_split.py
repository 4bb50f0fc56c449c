"""The tensor-core block-sparse kernels' arithmetic and plan, on the CPU.

The forward, dq and dk/dv kernels of ``csrc/block_sparse_attn.cu`` cannot
run here, so this file holds what they compute and how they are laid out
to the plain route, with numpy inputs from a seed:

  * a plain emulation of each kernel's arithmetic — operands split into
    bf16 terms (``repro_torch.kernels.split``) with the term products
    i + j <= 2 kept; the forward over its CSR pair list in stages of 64
    keys (32 for fp32 inputs; the plan's stages at D = 256) with the
    online rescale from the floor c, bf16 scores near each stage's maximum
    taken in fp32 above D = 128, and fp32 inputs' scores (and dP in the
    backward) as plain fp32 products; dq
    over the same list and stages, its scores summed from zero at each
    16-wide k-step and dS split into three terms; dk/dv
    over ``group_by_key``'s pair order in stages of 32 queries — against
    ``block_sparse_attention_ref`` / ``block_sparse_attention_bwd_dq_ref`` /
    ``block_sparse_attention_bwd_dkv_ref`` at the card's tolerances
    (normalized numerator and row sums rtol/atol 1e-4, mt abs 1e-5,
    gradients 1e-4 of their largest magnitude) over
    ``tests/harness.py::OP_SWEEP`` and over qwen3-1.7b-width tiles (d = b =
    128) at small n, bf16 and fp32, with a hot key tile, a query tile
    without pairs and a padded head dim;
  * the mirrors of the kernels' plan: shared memory within the 227 KB a
    block may use for every built (dtype, d, b) of the three kernels, two
    blocks an SM planned at the training shapes in bf16, and the launch
    geometry;
  * the heaviest-first tile order is a permutation that covers every tile
    once, keeps a balanced list in natural order, and refuses nothing.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from harness import OP_SWEEP, make_op_inputs
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels.split import operand_terms, term_products

BSA_TOL, MT_TOL = 1e-4, 1e-5  # chip_smoke.py phase 6
SCALE = 0.3


# --------------------------------------------------------------------------- #
# plain emulations of the two kernels
# --------------------------------------------------------------------------- #
def _live(fl, key_ok, qi, kj):
    """(len(qi), len(kj)) mask of one pair: valid, key mask, causal triangle
    on a diagonal block (query row >= key row within the block)."""
    m = key_ok[None, :].expand(len(qi), len(kj)).clone()
    if fl & 2:
        m &= qi[:, None] >= kj[None, :]
    return m if fl & 1 else torch.zeros_like(m)


def _stage(kernel, dtype, d, b):
    """Keys (fwd, dq) or queries (dk/dv) a ring stage: the kernel's plan
    where the shape is built, else its rule for the shapes below D = 128
    (64 / 32 keys in bf16 / fp32, 32 queries)."""
    if (bsa.padded_dim(d), b) in bsa.KERNEL_SHAPES:
        return bsa.kernel_plan(kernel, dtype, d, b)["stage"]
    if kernel == "dkv":
        return min(32, b)
    return min(64 if dtype == torch.bfloat16 else 32, b)


def fwd_emulated(q, k, v, c, pairs, key_mask, *, scale, block_size):
    """bsa_fwd_kernel's arithmetic: (out, rowsum, mt) fp32."""
    BHG, n, d = q.shape
    G, b = BHG // k.shape[0], block_size
    nb = n // b
    kt = _stage("fwd", q.dtype, d, b)
    exact = q.dtype == torch.float32  # fp32 scores: a plain fp32 product
    # bf16 inputs above D = 128 recompute the winning scores in fp32
    recompute = not exact and bsa.padded_dim(d) > 128
    out = torch.zeros((BHG, n, d))
    rowsum, mt = torch.zeros((BHG, n)), torch.zeros((BHG, n))
    rows = torch.arange(b)
    for r, x in itertools.product(range(BHG), range(nb)):
        qs = slice(x * b, (x + 1) * b)
        q_terms = operand_terms(q[r, qs])
        m = torch.full((b,), float(c[r, x]))
        lsum, o = torch.zeros(b), torch.zeros((b, d))
        for p in range(int(pairs.ptr[r, x]), int(pairs.ptr[r, x + 1])):
            y, fl = int(pairs.y[r, p]), int(pairs.flags[r, p])
            for k0 in range(0, b, kt):
                ks = slice(y * b + k0, y * b + k0 + kt)
                ok = _live(fl, key_mask[r // G, ks] > 0, rows, rows[k0:k0 + kt])
                if exact:
                    s = (q[r, qs] @ k[r // G, ks].T) * scale
                else:
                    s = term_products(q_terms, [t.T for t in operand_terms(
                        k[r // G, ks])]) * scale
                s = torch.where(ok, s, -torch.inf)
                mx = torch.where(ok.any(1), s.amax(1), torch.tensor(-1e9))
                if recompute:  # the scores near the stage's max in fp32
                    fp32 = (q[r, qs].float() @ k[r // G, ks].float().T) * scale
                    near = s >= (mx - 1e-5 * (1 + mx.abs()))[:, None]
                    mx = torch.where(near, fp32, -1e9).amax(1)
                m_new = torch.maximum(m, mx)
                a = torch.where(ok, torch.exp(torch.clamp(
                    s - m_new[:, None], max=0.0)), 0.0)
                alpha = torch.exp(m - m_new)
                lsum = lsum * alpha + a.sum(1)
                o = o * alpha[:, None] + term_products(
                    operand_terms(a), operand_terms(v[r // G, ks]))
                m = m_new
        out[r, qs], rowsum[r, qs], mt[r, qs] = o, lsum, m
    return out, rowsum, mt


def dkv_emulated(q, k, v, mt, do, dr, pairs, key_mask, *, scale, block_size):
    """bsa_bwd_dkv_kernel's arithmetic over ``group_by_key``'s pairs:
    (dk, dv) fp32."""
    BHG, n, d = q.shape
    BHKV, b = k.shape[0], block_size
    nb = n // b
    qt = _stage("dkv", q.dtype, d, b)
    dk, dv = torch.zeros((BHKV, n, d)), torch.zeros((BHKV, n, d))
    rows = torch.arange(b)
    for h, y in itertools.product(range(BHKV), range(nb)):
        ks = slice(y * b, (y + 1) * b)
        k_terms, v_terms = operand_terms(k[h, ks]), operand_terms(v[h, ks])
        key_ok = key_mask[h, ks] > 0
        gk, gv = torch.zeros((b, d)), torch.zeros((b, d))
        for p in range(int(pairs.ptr[h, y]), int(pairs.ptr[h, y + 1])):
            r, x = int(pairs.rows[h, p]), int(pairs.x[h, p])
            fl = int(pairs.flags[h, p])
            for q0 in range(0, b, qt):
                qs = slice(x * b + q0, x * b + q0 + qt)
                ok = _live(fl, key_ok, rows[q0:q0 + qt], rows).T
                q_terms, do_terms = operand_terms(q[r, qs]), operand_terms(do[r, qs])
                if q.dtype == torch.float32:  # Sᵀ, dPᵀ: plain fp32 products
                    st = k[h, ks] @ q[r, qs].T
                    dpt = v[h, ks] @ do[r, qs].T
                else:
                    st = term_products(k_terms, [t.T for t in q_terms])
                    dpt = term_products(v_terms, [t.T for t in do_terms])
                a = torch.where(ok, torch.exp(torch.clamp(
                    st * scale - mt[r, qs][None], max=0.0)), 0.0)
                ds = a * (dpt + dr[r, qs][None])
                gv = gv + term_products(operand_terms(a), do_terms)
                gk = gk + term_products(operand_terms(ds), q_terms)
        dk[h, ks], dv[h, ks] = gk * scale, gv
    return dk, dv


def dq_emulated(q, k, v, mt, do, dr, pairs, key_mask, *, scale, block_size):
    """bsa_bwd_dq_kernel's arithmetic over ``group_by_query``'s pairs: dq
    fp32. A query tile without pairs stays 0."""
    BHG, n, d = q.shape
    G, b = BHG // k.shape[0], block_size
    nb = n // b
    kt = _stage("dq", q.dtype, d, b)
    dq = torch.zeros((BHG, n, d))
    rows = torch.arange(b)
    for r, x in itertools.product(range(BHG), range(nb)):
        qs = slice(x * b, (x + 1) * b)
        q_terms, do_terms = operand_terms(q[r, qs]), operand_terms(do[r, qs])
        acc = torch.zeros((b, d))
        for p in range(int(pairs.ptr[r, x]), int(pairs.ptr[r, x + 1])):
            y, fl = int(pairs.y[r, p]), int(pairs.flags[r, p])
            for k0 in range(0, b, kt):
                ks = slice(y * b + k0, y * b + k0 + kt)
                ok = _live(fl, key_mask[r // G, ks] > 0, rows, rows[k0:k0 + kt])
                k_terms = operand_terms(k[r // G, ks])
                if q.dtype == torch.float32:  # S, dP: plain fp32 products
                    s = q[r, qs] @ k[r // G, ks].T
                    dp = do[r, qs] @ v[r // G, ks].T
                else:
                    s = sum(term_products([t[:, c:c + 16] for t in q_terms],
                                          [t[:, c:c + 16].T for t in k_terms])
                            for c in range(0, d, 16))
                    dp = term_products(do_terms, [t.T for t in operand_terms(
                        v[r // G, ks])])
                a = torch.where(ok, torch.exp(torch.clamp(
                    s * scale - mt[r, qs][:, None], max=0.0)), 0.0)
                ds = a * (dp + dr[r, qs][:, None])
                acc = acc + term_products(operand_terms(ds), k_terms)
        dq[r, qs] = acc * scale
    return dq


# --------------------------------------------------------------------------- #
# cases
# --------------------------------------------------------------------------- #
def _normalized(out, rs):
    alive = rs > 0
    return torch.where(alive[..., None], out, 0.0) / torch.where(
        alive, rs, 1.0)[..., None]


def _scaled_close(got, want, tol=BSA_TOL):
    s = float(want.abs().max()) or 1.0
    return bool(torch.isclose(got / s, want / s, rtol=tol, atol=tol).all())


def _op_case(case, dtype):
    q, k, v, c, x, y, fl, km = (None if a is None else torch.from_numpy(
        np.array(a)) for a in make_op_inputs(case))
    if km is None:
        km = torch.ones(k.shape[:2], dtype=torch.int32)
    return (q.to(dtype), k.to(dtype), v.to(dtype), c, x, y, fl, km, case.b)


def _wide_case(seed, *, BHKV, G, n, d, b, m, dtype, hot=False,
               unvisited=False):
    """qwen3-1.7b-like tiles: random pairs with a causal diagonal, one
    invalid pair a row, keys masked at random; ``hot``: every query block of
    each row also selects key block 0; ``unvisited``: query block 1 of row 0
    has no pairs."""
    r = np.random.default_rng(seed)
    BHG, nb = BHKV * G, n // b
    x = r.integers(0, nb, (BHG, m))
    y = r.integers(0, nb, (BHG, m))
    if hot:
        x[:, :nb] = np.arange(nb)
        y[:, :nb] = 0
    if unvisited:
        x[0] = np.where(x[0] == 1, 0, x[0])
    flags = np.ones((BHG, m), np.int32)
    flags[:, -1] = 0
    flags |= 2 * (x == y)
    T = torch.from_numpy
    return (T(r.standard_normal((BHG, n, d)).astype(np.float32)).to(dtype),
            T(r.standard_normal((BHKV, n, d)).astype(np.float32)).to(dtype),
            T(r.standard_normal((BHKV, n, d)).astype(np.float32)).to(dtype),
            T(r.standard_normal((BHG, nb)).astype(np.float32)),
            T(x.astype(np.int32)), T(y.astype(np.int32)), T(flags),
            T(r.integers(0, 2, (BHKV, n)).astype(np.int32)), b)


WIDE = {"d128-b128-g2": dict(BHKV=2, G=2, n=512, d=128, b=128, m=8),
        "d128-b128-g1-hot": dict(BHKV=2, G=1, n=512, d=128, b=128, m=6,
                                 hot=True),
        "d128-b128-g2-unvisited": dict(BHKV=1, G=2, n=512, d=128, b=128,
                                       m=8, unvisited=True),
        "d64-b64-g2": dict(BHKV=1, G=2, n=256, d=64, b=64, m=6),
        # recurrentgemma's local layers under MRA-2 (16- and 32-key stages)
        "d256-b128-g4": dict(BHKV=1, G=4, n=256, d=256, b=128, m=4),
        "d12-b16-g2-hot": dict(BHKV=2, G=2, n=96, d=12, b=16, m=9, hot=True)}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _cases():
    for case, dt in itertools.product(OP_SWEEP, DTYPES):
        yield pytest.param(("op", case, dt), id=f"{case.id}-{dt}")
    for name, dt in itertools.product(WIDE, DTYPES):
        yield pytest.param(("wide", name, dt), id=f"{name}-{dt}")


def _inputs(spec):
    kind, case, dt = spec
    if kind == "op":
        return _op_case(case, DTYPES[dt])
    return _wide_case(len(case), dtype=DTYPES[dt], **WIDE[case])


@pytest.mark.parametrize("spec", list(_cases()))
def test_split_kernels_match_the_plain_reference(spec):
    q, k, v, c, x, y, fl, km, b = _inputs(spec)
    G, nb = q.shape[0] // k.shape[0], q.shape[1] // b
    kw = dict(scale=SCALE, block_size=b)
    out, rs, mt = fwd_emulated(q, k, v, c, bsa.group_by_query(x, y, fl, nb),
                               km, **kw)
    ref = bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw)
    assert torch.equal(rs > 0, ref[1] > 0)
    assert bool(torch.isclose(_normalized(out, rs), _normalized(*ref[:2]),
                              rtol=BSA_TOL, atol=BSA_TOL).all())
    assert bool(torch.isclose(rs, ref[1], rtol=BSA_TOL, atol=BSA_TOL).all())
    assert float((mt - ref[2]).abs().max()) <= MT_TOL

    r = np.random.default_rng(7)
    do = torch.from_numpy(r.standard_normal(tuple(q.shape)).astype(np.float32))
    dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2])).astype(np.float32))
    dk, dv = dkv_emulated(q, k, v, ref[2], do, dr,
                          bsa.group_by_key(x, y, fl, G, nb), km, **kw)
    want = bsa.block_sparse_attention_bwd_dkv_ref(q, k, v, c, x, y, fl, km, do,
                                                  dr, **kw)
    assert _scaled_close(dk, want[0]) and _scaled_close(dv, want[1])


@pytest.mark.parametrize("spec", list(_cases()))
def test_split_dq_matches_the_plain_reference(spec):
    q, k, v, c, x, y, fl, km, b = _inputs(spec)
    nb = q.shape[1] // b
    kw = dict(scale=SCALE, block_size=b)
    pq = bsa.group_by_query(x, y, fl, nb)
    mt = bsa.block_sparse_attention_ref(q, k, v, x, y, fl, c, km, **kw)[2]
    r = np.random.default_rng(7)
    do = torch.from_numpy(r.standard_normal(tuple(q.shape)).astype(np.float32))
    dr = torch.from_numpy(r.standard_normal(tuple(q.shape[:2])).astype(np.float32))
    dq = dq_emulated(q, k, v, mt, do, dr, pq, km, **kw)
    want = bsa.block_sparse_attention_bwd_dq_ref(q, k, v, c, x, y, fl, km, do,
                                                 dr, **kw)
    assert _scaled_close(dq, want)
    empty = (bsa.pairs_per_tile(pq.ptr) == 0).reshape(q.shape[0], nb)
    rows = empty.repeat_interleave(b, 1)
    assert int(torch.count_nonzero(dq[rows])) == 0
    assert int(torch.count_nonzero(want[rows])) == 0
    if spec[0] == "wide" and WIDE[spec[1]].get("unvisited"):
        assert bool(empty[0, 1])


def test_hot_key_tile_walks_far_more_pairs_than_the_mean():
    q, k, v, c, x, y, fl, km, b = _inputs(("wide", "d128-b128-g1-hot", "bf16"))
    counts = bsa.pairs_per_tile(bsa.group_by_key(x, y, fl, 1, 4).ptr).float()
    assert float(counts.max()) > 2 * float(counts.mean())


# --------------------------------------------------------------------------- #
# the plan: shared memory, blocks per SM, launch geometry
# --------------------------------------------------------------------------- #
BUILT = [(D, b) for D, b in bsa.KERNEL_SHAPES] + [(12, 16)]


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("d,b", BUILT)
def test_smem_fits_a_block_and_the_plan_is_consistent(kernel, dtype, d, b):
    plan = bsa.kernel_plan(kernel, dtype, d, b)
    assert plan["smem_bytes"] <= 232448 and plan["smem_bytes"] % 16 == 0
    assert plan["threads"] == 2 * plan["rows"] * plan["col_split"]
    assert plan["rows"] % 16 == 0 and plan["col_split"] == (2 if d > 128 else 1)
    assert plan["rows"] * plan["sub_tiles"] == b and b % plan["stage"] == 0
    assert bsa.planned_blocks_per_sm(kernel, dtype, d, b) >= 1


@pytest.mark.parametrize("kernel", ["fwd", "dkv", "dq"])
def test_training_shapes_plan_two_blocks_an_sm_in_bf16(kernel):
    """qwen3-1.7b (d = b = 128) in bf16: 64 rows a block, two blocks an SM
    by shared memory (the forward three)."""
    plan = bsa.kernel_plan(kernel, torch.bfloat16, 128, 128)
    assert plan["rows"] == 64 and plan["threads"] == 128
    assert plan["stage"] == (32 if kernel == "dkv" else 64)
    assert bsa.planned_blocks_per_sm(kernel, torch.bfloat16, 128, 128) == (
        3 if kernel == "fwd" else 2)


@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
def test_forward_only_shape_plans_two_blocks_an_sm(dtype):
    """granite-moe's (d, b) = (64, 128), once built for the forward alone
    (whole-prompt prefill), now for all three kernels (MoE training): two
    64-row blocks a tile, at least two blocks an SM by shared memory, three
    in bf16 for the forward and dq, four for dk/dv."""
    for kernel in ("fwd", "dq", "dkv"):
        plan = bsa.kernel_plan(kernel, dtype, 64, 128)
        assert (plan["rows"], plan["sub_tiles"], plan["threads"]) == (
            64, 2, 128)
        assert plan["stage"] == (64 if dtype == torch.bfloat16
                                 and kernel != "dkv" else 32)
        assert plan["smem_bytes"] <= 232448 and plan["smem_bytes"] % 16 == 0
        assert bsa.planned_blocks_per_sm(kernel, dtype, 64, 128) >= 2
    assert (64, 128) in bsa.KERNEL_SHAPES
    bsa.check_shape(64, 128)
    bsa.check_shape(56, 128)  # padded to 64


@pytest.mark.parametrize("kernel,dtype,smem,blocks", [
    ("dq", torch.bfloat16, 57856, 3), ("dq", torch.float32, 106752, 2),
    ("dkv", torch.bfloat16, 53760, 4), ("dkv", torch.float32, 107008, 2)])
def test_granite_backward_plan(kernel, dtype, smem, blocks):
    """dq and dk/dv at (64, 128): the shared memory of ``DqGeo`` /
    ``DkvGeo`` (two K/V ring slots of 64 keys in bf16, 32 in fp32, and
    three planes of split do; dk/dv's K/V planes, ring and do planes), the
    blocks an SM that shared memory allows, and the launch of granite's
    training call (B = 2, 24 query / 8 KV heads, n = 4096: 1536 query
    tiles, 512 key tiles, two blocks a tile)."""
    assert bsa.smem_bytes(kernel, dtype, 64, 128) == smem
    assert bsa.planned_blocks_per_sm(kernel, dtype, 64, 128) == blocks
    tiles = 2 * (24 if kernel == "dq" else 8) * 32
    assert bsa.launch_geometry(kernel, dtype, 64, 128, tiles)["grid"] == (
        2 * tiles)


def test_launch_geometry_of_the_training_call():
    """BSA_MAIN: 32 BHG rows and 16 KV heads of 32 blocks each, two 64-row
    blocks a tile: 2048 forward, 2048 dq and 1024 dk/dv blocks; dq's block
    holds the two-slot K/V ring and three planes of split do (115,200
    bytes)."""
    fwd = bsa.launch_geometry("fwd", torch.bfloat16, 128, 128, 32 * 32)
    dq = bsa.launch_geometry("dq", torch.bfloat16, 128, 128, 32 * 32)
    dkv = bsa.launch_geometry("dkv", torch.bfloat16, 128, 128, 16 * 32)
    assert (fwd["grid"], dq["grid"], dkv["grid"]) == (2048, 2048, 1024)
    assert fwd["smem_bytes"] == bsa.smem_bytes("fwd", torch.bfloat16, 128, 128)
    assert dq["smem_bytes"] == 2 * 33024 + 3 * 64 * 128 * 2 == 115200
    small = bsa.launch_geometry("dkv", torch.float32, 12, 16, 10)
    assert small["grid"] == 10 and small["threads"] == 32


@pytest.mark.parametrize("kernel,dtype,smem,blocks", [
    ("fwd", torch.bfloat16, 45568, 5), ("dq", torch.bfloat16, 79360, 2),
    ("dkv", torch.bfloat16, 71680, 3), ("fwd", torch.float32, 96512, 2),
    ("dq", torch.float32, 142592, 1), ("dkv", torch.float32, 142848, 1)])
def test_head_dim_80_plan(kernel, dtype, smem, blocks):
    """hubert-xlarge's (80, 128): a bf16 plane row of ten 16-byte chunks is
    padded to eleven (176 bytes: the same chunk of 8 consecutive rows in 8
    distinct bank groups, no swizzle), which sets the shared memory of
    every tile; two or more blocks an SM by shared memory in bf16. The
    power-of-two rows keep their width."""
    assert [bsa.plane_row_bytes(D) for D in (16, 64, 80, 128)] == [
        32, 128, 176, 256]
    assert (80, 128) in bsa.KERNEL_SHAPES
    assert bsa.smem_bytes(kernel, dtype, 80, 128) == smem
    assert bsa.planned_blocks_per_sm(kernel, dtype, 80, 128) == blocks
    assert bsa.launch_geometry(kernel, dtype, 80, 128, 32 * 32)["grid"] == 2048


@pytest.mark.parametrize("kernel,dtype,smem,blocks", [
    ("fwd", torch.bfloat16, 61952, 3), ("dq", torch.bfloat16, 108032, 2),
    ("dkv", torch.bfloat16, 98304, 2), ("fwd", torch.float32, 133376, 1),
    ("dq", torch.float32, 195840, 1), ("dkv", torch.float32, 196096, 1)])
def test_head_dim_112_plan(kernel, dtype, smem, blocks):
    """kimi-k2's (112, 128): one warp a 16-row slab owns all 112 columns
    (col_split 1, as at D <= 128); a bf16 plane row of fourteen 16-byte
    chunks is padded to fifteen (240 bytes), so every bf16 tile fits two
    blocks an SM by shared memory, as (128, 128)'s do."""
    assert bsa.plane_row_bytes(112) == 240
    assert bsa.column_split(112) == 1
    assert bsa.smem_bytes(kernel, dtype, 112, 128) == smem
    assert bsa.planned_blocks_per_sm(kernel, dtype, 112, 128) == blocks
    assert bsa.planned_blocks_per_sm(kernel, dtype, 112, 128) >= (
        bsa.planned_blocks_per_sm(kernel, dtype, 128, 128))
    assert bsa.launch_geometry(kernel, dtype, 112, 128, 32 * 32)["grid"] == 2048


@pytest.mark.parametrize("kernel,dtype,rows,stage,smem", [
    ("fwd", torch.bfloat16, 64, 64, 164352),
    ("dq", torch.bfloat16, 64, 32, 196864),
    ("dkv", torch.bfloat16, 64, 32, 213504),
    ("fwd", torch.float32, 32, 16, 197248),
    ("dq", torch.float32, 32, 16, 213120),
    ("dkv", torch.float32, 32, 16, 213248)])
def test_head_dim_256_plan(kernel, dtype, rows, stage, smem):
    """recurrentgemma's (256, 128): two warps share each 16 rows (128
    columns of the accumulators each), q lies in shared-memory planes; a
    bf16 block is 64 rows in eight warps, an fp32 one 32 rows in four with
    16-row stages (the split planes of more would not fit), one block an
    SM by shared memory either way. The training call (B = 2, 16 query
    heads over one KV head, n = 4096) launches 1024 query-tile blocks of
    the forward and dq in bf16 (2048 in fp32) and 64 key-tile blocks of
    dk/dv (128)."""
    plan = bsa.kernel_plan(kernel, dtype, 256, 128)
    assert (plan["rows"], plan["stage"], plan["smem_bytes"]) == (
        rows, stage, smem)
    assert plan["col_split"] == 2 and plan["threads"] == 4 * rows
    assert bsa.planned_blocks_per_sm(kernel, dtype, 256, 128) == 1
    tiles = 2 * (16 if kernel != "dkv" else 1) * 32
    assert bsa.launch_geometry(kernel, dtype, 256, 128, tiles)["grid"] == (
        tiles * 128 // rows)
    bsa.check_shape(248, 128)  # padded to 256


@pytest.mark.parametrize("d,b", [(32, 64), (128, 64), (16, 128), (130, 128),
                                 (80, 64), (96, 128), (256, 64)])
def test_unbuilt_shapes_are_refused(d, b):
    with pytest.raises(ValueError, match="is not built"):
        bsa.check_shape(d, b)
    with pytest.raises(ValueError, match="is not built"):
        bsa.kernel_plan("fwd", torch.bfloat16, d, b)


# --------------------------------------------------------------------------- #
# the heaviest-first tile order
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_tile_order_is_a_heaviest_first_permutation(seed):
    r = np.random.default_rng(seed)
    counts = torch.from_numpy(r.integers(0, 9, (5, 12)).astype(np.int32))
    ptr = torch.cat([torch.zeros((5, 1), dtype=torch.int32),
                     torch.cumsum(counts, 1, dtype=torch.int32)], 1)
    order = bsa.tile_order(ptr)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(60))
    flat = counts.reshape(-1)[order.long()]
    assert bool((flat[:-1] >= flat[1:]).all())
    for a, b in zip(order.tolist(), order.tolist()[1:]):  # ties: natural order
        if counts.reshape(-1)[a] == counts.reshape(-1)[b]:
            assert a < b


def test_tile_order_keeps_a_balanced_list_in_natural_order():
    ptr = torch.arange(0, 4 * 9, 4, dtype=torch.int32).reshape(1, 9)
    assert bsa.tile_order(ptr).tolist() == list(range(8))
