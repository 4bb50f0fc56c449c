"""Port parity: repro_torch.core.hier + the H-level fold vs the JAX package.

The same numpy inputs go through ``repro.core.hier`` and the port's
``repro_torch.core.hier`` (collapse tables and values, the upper view, the
eviction schedule, the streaming builder), and through the reference's jnp
route of ``mra2_chunk_attention`` and the port's plain route with an
H-level view. Tolerances: tables, counts and selections exactly; fp32
payloads within 1e-5 of their tensor's largest magnitude (sums in another
order); int8 codes within one step (a rounding boundary); attention outputs
atol 2e-5 / rtol 1e-5 (the serving kernel's own tolerance); the
``hier_decode_err_h{2,3,4}`` errors within 1e-5 relative. The four collapse
properties of ``tests/test_hier_pyramid.py`` are rerun on the port over
their fixed example grids.
"""
from __future__ import annotations

import importlib.util
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier as jh
from repro.core import mra_decode as jmd
from repro.core.mra import MraConfig as JMraConfig
from repro_torch.core import hier as th
from repro_torch.core import mra_decode as tmd
from repro_torch.core.mra import MraConfig
from test_chunk_kernel import Case, make_case_inputs
from test_hier_pyramid import _ORDER_GRID, _STREAM_GRID
from test_torch_mra_decode import ATOL, RTOL, N, T, _dequant_pyramid


def _structured_qkv(*args, **kw):
    """``benchmarks/common.py::structured_qkv``, loaded from its file (the
    benchmarks folder is no package)."""
    path = Path(__file__).resolve().parent.parent / "benchmarks" / "common.py"
    spec = importlib.util.spec_from_file_location("_bench_common", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.structured_qkv(*args, **kw)


def _kv(seed, B, Hkv, S, D):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, Hkv, S, D)).astype(np.float32),
            r.standard_normal((B, Hkv, S, D)).astype(np.float32))


def _assert_tree_close(tc, jc):
    """Cache dicts: integer tables exactly, fp32 normwise, int8 one step."""
    assert set(tc) == set(jc)
    for key, jv in jc.items():
        pairs = zip(tc[key], jv) if isinstance(jv, list) else [(tc[key], jv)]
        for t, j in pairs:
            t, j = N(t), np.asarray(j)
            if j.dtype == np.int8:
                assert np.abs(t.astype(np.int32) - j.astype(np.int32)).max() <= 1, key
            elif np.issubdtype(j.dtype, np.integer) or j.dtype == bool:
                np.testing.assert_array_equal(t, j, err_msg=key)
            else:
                scale = max(1.0, float(np.abs(j).max()))
                np.testing.assert_allclose(t, j, atol=1e-5 * scale, rtol=0,
                                           err_msg=key)


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #
def _tables(r, B, ns):
    owners, counts = [], []
    for n in ns:
        own = r.integers(-1, 12, (B, n)).astype(np.int32)
        cnt = np.where(own >= 0, r.integers(1, 40, (B, n)), 0).astype(np.int32)
        owners.append(own)
        counts.append(cnt)
    return owners, counts


@pytest.mark.parametrize("seed", range(4))
def test_collapse_tables_and_values_match_jax(seed):
    """One carry chain over random tables (matches, evictions, fresh claims,
    rows that evict nothing) and its replay on quantized and fp32 payloads."""
    r = np.random.default_rng(seed)
    B, Hkv, D, ns = 5, 2, 6, (3, 2, 4)
    owners, counts = _tables(r, B, ns)
    tail = r.integers(0, 50, (B,)).astype(np.int32)
    blk = r.integers(0, 24, (B,)).astype(np.int32)
    blk[0] = 2 * owners[0][0, blk[0] // 2 % ns[0]] + 1  # a level-2 match
    present = np.array([True, True, False, True, True])
    child = np.full((B,), 16, np.int32)
    jo, jc, jt, jplan = jh.collapse_tables(
        [jnp.asarray(o) for o in owners], [jnp.asarray(c) for c in counts],
        jnp.asarray(tail), jnp.asarray(blk), jnp.asarray(child),
        jnp.asarray(present))
    to, tcn, tt, tplan = th.collapse_tables(
        [T(o) for o in owners], [T(c) for c in counts], T(tail), T(blk),
        T(child), T(present))
    for a, b in zip(to + tcn + [tt], list(jo) + list(jc) + [jt]):
        np.testing.assert_array_equal(N(a), np.asarray(b))
    for tp, jp in zip(tplan.levels, jplan.levels):
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(N(a), np.asarray(b))
    np.testing.assert_array_equal(N(tplan.tail_on), np.asarray(jplan.tail_on))
    np.testing.assert_array_equal(N(tplan.tail_cnt), np.asarray(jplan.tail_cnt))
    for a, b in zip(owners, to):  # inputs untouched
        assert not np.shares_memory(a, N(b))

    ck = r.standard_normal((B, Hkv, D)).astype(np.float32) * 16
    cv = r.standard_normal((B, Hkv, D)).astype(np.float32) * 16
    tk = r.standard_normal((B, Hkv, D)).astype(np.float32)
    tv = r.standard_normal((B, Hkv, D)).astype(np.float32)
    for quant in (True, False):
        qmaxs = tuple(jh.level_qmax(l) for l in range(2, 2 + len(ns))) \
            if quant else None
        pay = []
        for n in ns:
            q = (r.integers(-127, 128, (B, Hkv, n, D)).astype(np.int8) if quant
                 else r.standard_normal((B, Hkv, n, D)).astype(np.float32))
            pay.append((q, r.random((B, Hkv, n)).astype(np.float32) * 0.1))
        args = [[p[0] for p in pay], [p[0] for p in pay],
                [p[1] for p in pay], [p[1] for p in pay]]
        jout = jh.collapse_values(
            *[[jnp.asarray(x) for x in a] for a in args], jnp.asarray(tk),
            jnp.asarray(tv), jplan, jnp.asarray(ck), jnp.asarray(cv), qmaxs)
        tout = th.collapse_values(
            *[[T(x) for x in a] for a in args], T(tk), T(tv), tplan, T(ck),
            T(cv), qmaxs)
        names = ("kq", "vq", "ks", "vs")
        _assert_tree_close(
            {n: list(t) for n, t in zip(names, tout[:4])}
            | {"tail_k": tout[4], "tail_v": tout[5]},
            {n: list(j) for n, j in zip(names, jout[:4])}
            | {"tail_k": jout[4], "tail_v": jout[5]})
        off = ~present  # rows without a carry keep their bits
        for t, a in zip(tout[0], args[0]):
            np.testing.assert_array_equal(N(t)[off], a[off])


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_quantize_mean_matches_jax(qmax):
    r = np.random.default_rng(int(qmax))
    x = (r.standard_normal((3, 2, 5, 16)) * 4).astype(np.float32)
    x[0, 0, 0] = 0.0  # the 1e-8 scale floor
    # exact half steps of a 0.5 scale: ties round to even in both
    x[1, 0, 0] = 0.0
    x[1, 0, 0, :5] = np.array([qmax, 0.5, 1.5, 2.5, -2.5]) * 0.5
    jq, js = jh.quantize_mean(jnp.asarray(x), qmax)
    tq, ts = th.quantize_mean(T(x), qmax)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(N(tq), np.asarray(jq))
    np.testing.assert_array_equal(N(tq)[1, 0, 0, 1:5], [0, 2, 2, -2])
    np.testing.assert_array_equal(N(ts), np.asarray(js))


@pytest.mark.parametrize("seed", range(3))
def test_upper_view_and_eviction_schedule_match_jax(seed):
    r = np.random.default_rng(seed)
    B, Hkv, D, ns = 3, 2, 4, (4, 2)
    kq = [r.integers(-127, 128, (B, Hkv, n, D)).astype(np.int8) for n in ns]
    ks = [r.random((B, Hkv, n)).astype(np.float32) for n in ns]
    cnt = [r.integers(0, 30, (B, n)).astype(np.int32) for n in ns]
    tk = r.standard_normal((B, Hkv, D)).astype(np.float32) * 9
    tcnt = np.array([0, 7, 300], np.int32)
    jv = jh.upper_view([jnp.asarray(x) for x in kq], [jnp.asarray(x) for x in kq],
                       [jnp.asarray(x) for x in ks], [jnp.asarray(x) for x in ks],
                       [jnp.asarray(x) for x in cnt], jnp.asarray(tk),
                       jnp.asarray(tk), jnp.asarray(tcnt))
    tv = th.upper_view([T(x) for x in kq], [T(x) for x in kq],
                       [T(x) for x in ks], [T(x) for x in ks],
                       [T(x) for x in cnt], T(tk), T(tk), T(tcnt))
    assert tv.k_mean.shape == (B, Hkv, sum(ns) + 1, D)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(N(a), np.asarray(b), rtol=1e-6, atol=0)

    nb = 6
    old = r.integers(-1, 20, (B, nb)).astype(np.int32)
    fresh = r.random((B, nb)) < 0.5
    fresh[0] = False  # a row that evicts nothing
    for rounds in (2, nb + 3):
        js = jh.eviction_schedule(jnp.asarray(old), jnp.asarray(fresh), rounds)
        ts = th.eviction_schedule(T(old), T(fresh), rounds)
        assert len(ts) == len(js) == min(rounds, nb)
        for (tb, to), (jb, jo) in zip(ts, js):
            np.testing.assert_array_equal(N(tb), np.asarray(jb))
            np.testing.assert_array_equal(N(to), np.asarray(jo))


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("shape,seed", _STREAM_GRID)
def test_build_hier_stream_matches_jax(shape, seed, quantize):
    """The streaming builder over the reference's grid (levels 3 / 4 / 5,
    two layers): tables and counts exactly, payloads as the module says."""
    B, Hkv, nblk, D, levels = shape
    k, v = _kv(seed, B, Hkv, nblk * 4, D)
    kw = dict(block=4, nb=4, levels=levels, quantize=quantize, num_layers=2)
    jc = jh.build_hier_stream(jnp.asarray(k), jnp.asarray(v), **kw)
    tc = th.build_hier_stream(T(k), T(v), **kw)
    _assert_tree_close(tc, jc)
    assert tc["hier_k2"][0] is not tc["hier_k2"][1]  # no aliased layers


# --------------------------------------------------------------------------- #
# the collapse properties, rerun on the port
# --------------------------------------------------------------------------- #
def _upper_sums(cache):
    up = th.cache_upper_view(cache, 0)
    cnt = up.counts[:, None, :, None]
    return (up.k_mean * cnt).sum(2), (up.v_mean * cnt).sum(2)


@pytest.mark.parametrize("shape,seed", _STREAM_GRID)
def test_total_sum_conservation(shape, seed):
    B, Hkv, nblk, D, levels = shape
    k, v = _kv(seed, B, Hkv, nblk * 4, D)
    cache = th.build_hier_stream(T(k), T(v), block=4, nb=4, levels=levels,
                                 quantize=False)
    ks, vs = _upper_sums(cache)
    np.testing.assert_allclose(N(ks + cache["pyr_k"][0].sum(2)), k.sum(2),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(N(vs + cache["pyr_v"][0].sum(2)), v.sum(2),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,seed", _STREAM_GRID)
def test_parent_is_sum_of_children(shape, seed):
    B, Hkv, nblk, D, levels = shape
    block, nb = 4, 4
    k, v = _kv(seed, B, Hkv, nblk * block, D)
    cache = th.build_hier_stream(T(k), T(v), block=block, nb=nb,
                                 levels=levels, quantize=False)
    own, cnt = N(cache["hier_own2"]), N(cache["hier_cnt2"])
    km = N(cache["hier_k2"][0]) * N(cache["hier_ks2"][0])[..., None]
    checked = 0
    for b in range(B):
        for s in range(own.shape[1]):
            if own[b, s] < 0 or cnt[b, s] != 2 * block:
                continue
            e = int(own[b, s])
            span = k[b, :, 2 * e * block:(2 * e + 2) * block]
            np.testing.assert_allclose(km[b, :, s] * cnt[b, s],
                                       span.sum(axis=1), rtol=1e-4, atol=1e-4)
            checked += 1
    if nblk >= 2 * nb:
        assert checked > 0


@pytest.mark.parametrize("seed,levels,perm", _ORDER_GRID)
def test_batched_collapse_is_order_invariant(seed, levels, perm):
    B, Hkv, D, block, n = 1, 2, 4, 4, 8
    r = np.random.default_rng(seed)
    blocks = [0, 6, 10]  # distinct level-2 ids and slots
    sums = [(T(r.standard_normal((B, Hkv, D)).astype(np.float32)),
             T(r.standard_normal((B, Hkv, D)).astype(np.float32)))
            for _ in blocks]

    def run(order):
        z = torch.zeros
        cache = {"tail_k": [z((B, Hkv, D))], "tail_v": [z((B, Hkv, D))],
                 "tail_cnt": z((B,), dtype=torch.int32)}
        for lv in range(2, levels):
            cache[f"hier_k{lv}"] = [z((B, Hkv, n, D))]
            cache[f"hier_v{lv}"] = [z((B, Hkv, n, D))]
            cache[f"hier_ks{lv}"] = [z((B, Hkv, n))]
            cache[f"hier_vs{lv}"] = [z((B, Hkv, n))]
            cache[f"hier_own{lv}"] = torch.full((B, n), -1, dtype=torch.int32)
            cache[f"hier_cnt{lv}"] = z((B, n), dtype=torch.int32)
        on = torch.ones((B,), dtype=torch.bool)
        cc = torch.full((B,), block, dtype=torch.int32)
        for j in order:
            upd, plan = th.cache_collapse_tables(
                cache, torch.full((B,), blocks[j], dtype=torch.int32), cc, on)
            th.cache_store_tables(cache, upd)
            th.cache_store_layer(cache, 0, th.cache_collapse_layer(
                cache, 0, plan, *sums[j], quantize=False))
        return cache

    a, b = run(range(len(blocks))), run(perm)
    for key in a:
        va = a[key][0] if isinstance(a[key], list) else a[key]
        vb = b[key][0] if isinstance(b[key], list) else b[key]
        np.testing.assert_allclose(N(va), N(vb), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("shape,seed", _STREAM_GRID)
def test_h2_build_matches_ring_eviction(shape, seed):
    B, Hkv, nblk, D, levels = shape
    k, v = _kv(seed, B, Hkv, nblk * 4, D)
    two = th.build_hier_stream(T(k), T(v), block=4, nb=4, levels=2)
    h = th.build_hier_stream(T(k), T(v), block=4, nb=4, levels=levels)
    assert not th.has_hier(two) and th.hier_level_ids(two) == ()
    for key in ("k_cache", "v_cache", "page_blocks", "pyr_k", "pyr_v"):
        a = two[key][0] if isinstance(two[key], list) else two[key]
        b = h[key][0] if isinstance(h[key], list) else h[key]
        assert torch.equal(a, b), key


# --------------------------------------------------------------------------- #
# attention with the H-level fold
# --------------------------------------------------------------------------- #
NU = 5  # e.g. levels 2-3 of two entries each + the tail


def _upper(seed, B, Hkv, D, pattern):
    """A random H-level view; ``pattern`` picks which entries are live.
    Two entries carry 3x keys so that their scores can lead the row max."""
    r = np.random.default_rng(seed)
    km = r.standard_normal((B, Hkv, NU, D)).astype(np.float32)
    km[:, :, 1:3] *= 3.0
    vm = r.standard_normal((B, Hkv, NU, D)).astype(np.float32)
    cnt = r.integers(1, 65, (B, NU)).astype(np.float32)
    if pattern == "some_dead":
        cnt[:, ::2] = 0.0
    elif pattern == "all_dead":
        cnt[:] = 0.0
    elif pattern == "tail_only":
        cnt[:, :-1] = 0.0
    return km, vm, cnt


def _hier_both(case: Case, C, pattern, cache_dtype, draft_level=1):
    """(port, reference, inputs, port config) of one chunk call with an
    H-level view of ``pattern`` (None: H = 2, no view) at ``draft_level``."""
    q, k, v, lengths, q_pos, pb, ks, vs = make_case_inputs(case, C=C)
    if cache_dtype == "bf16":  # the same bf16 values in both frameworks
        k, v = k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    if ks is not None:
        ksum, vsum = _dequant_pyramid(case, (q, k, v, lengths, q_pos, pb, ks, vs))
    else:
        nb = case.S // case.b
        pbt = pb if pb is not None else jmd.identity_page_table(case.B, nb)
        mask = np.asarray(jmd.paged_position_mask(lengths, pbt, case.S, case.b),
                          np.float32)[:, None, :, None]
        ksum, vsum = (np.asarray(x.astype(jnp.float32)) * mask for x in (k, v))
        ksum, vsum = (x.reshape(case.B, case.Hkv, nb, case.b, case.D).sum(3)
                      for x in (ksum, vsum))
    jup = tup = None
    if pattern is not None:
        km, vm, cnt = _upper(case.seed + 1, case.B, case.Hkv, case.D, pattern)
        jup = jh.HierUpper(jnp.asarray(km), jnp.asarray(vm), jnp.asarray(cnt))
        tup = th.HierUpper(T(km), T(vm), T(cnt))
    jpyr = jmd.PyramidState(jnp.asarray(ksum), jnp.asarray(vsum), jup)
    tpyr = tmd.PyramidState(T(ksum), T(vsum), tup)
    m = case.m
    jcfg = JMraConfig(block_size=case.b, causal=True, variant=case.variant,
                      draft_level=draft_level)
    tcfg = MraConfig(block_size=case.b, variant=case.variant,
                     draft_level=draft_level)
    ref = jmd.mra2_chunk_attention(
        q, k, v, lengths, q_pos, jcfg, decode_blocks=m, pyramid=jpyr,
        page_blocks=pb, k_scale=ks, v_scale=vs)

    def tt(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return T(x.astype(jnp.float32)).to(torch.bfloat16)
        return T(x)

    got = tmd.mra2_chunk_attention(
        tt(q), tt(k), tt(v), tt(lengths), tt(q_pos), tcfg, decode_blocks=m,
        pyramid=tpyr, page_blocks=tt(pb), k_scale=tt(ks), v_scale=tt(vs))
    return N(got), np.asarray(ref), (q, k, v, lengths, q_pos, pb, ks, vs), tcfg


PATTERNS = ("all_live", "some_dead", "all_dead", "tail_only")


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("C,cache_dtype,variant", list(itertools.product(
    (1, 8), ("bf16", "int8"), ("full", "sparse"))))
def test_chunk_attention_with_upper_matches_jax(C, cache_dtype, variant,
                                                pattern):
    """The port's plain route with an H-level view == the reference's jnp
    route: ring and ragged layouts (the ragged one has an empty slot, whose
    rows see no window key but live collapsed entries)."""
    for i, layout in enumerate(("paged", "ragged")):
        case = Case(quant=cache_dtype == "int8", variant=variant, group=2,
                    seed=40 + 3 * i + C, **{layout: True})
        got, ref, _, _ = _hier_both(case, C, pattern, cache_dtype)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=layout)
        if layout == "ragged" and variant == "full" and pattern != "all_dead":
            assert np.abs(got[0]).min() > 0.0  # empty window, live entries


@pytest.mark.parametrize("H", [2, 3])
@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("draft_level", [2, 3])
def test_draft_fold_matches_jax(draft_level, cache_dtype, H):
    """The speculative draft's grouped far field (draft_level > 1: a group
    of 2^(draft_level-1) adjacent pages that are all background for a row
    enters through its count-weighted mean, a mixed group page by page) in
    the port's plain twin == the reference's jnp route, at the drafts'
    budget m = 1 and at m = 3, on the ring and ragged layouts, with (H = 3)
    and without (H = 2) an H-level view; and the fold changes the result."""
    moved = {}
    for i, (layout, m) in enumerate((("paged", 1), ("ragged", 1),
                                     ("paged", 3))):
        case = Case(quant=cache_dtype == "int8", group=2, S=128, m=m,
                    seed=60 + 4 * i + draft_level, **{layout: True})
        pattern = "some_dead" if H == 3 else None
        got, ref, _, _ = _hier_both(case, 1, pattern, cache_dtype,
                                    draft_level)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{layout} m={m}")
        base, _, _, _ = _hier_both(case, 1, pattern, cache_dtype)
        moved[layout, m] = float(np.abs(got - base).max())
    assert moved["paged", 1] > 1e-4 and moved["paged", 3] > 1e-4, moved


def test_upper_fold_is_ignored_by_mra2_s_and_dead_entries():
    """MRA-2-s ignores the hierarchy; an all-dead view adds nothing."""
    for variant, pattern in (("sparse", "all_live"), ("full", "all_dead")):
        case = Case(paged=True, group=2, seed=7, variant=variant)
        got, _, inputs, tcfg = _hier_both(case, 8, pattern, "bf16")
        q, k, v, lengths, q_pos, pb, _, _ = inputs
        kf = T(k.astype(jnp.float32)).to(torch.bfloat16)
        vf = T(v.astype(jnp.float32)).to(torch.bfloat16)
        base = tmd.mra2_chunk_attention(
            T(q), kf, vf, T(lengths), T(q_pos), tcfg, decode_blocks=case.m,
            page_blocks=T(pb))
        np.testing.assert_allclose(got, N(base), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H", [2, 3, 4])
def test_hier_decode_err_matches_jax(H):
    """approx_error's hier_decode_err_h{H} on structured_qkv inputs: the
    port's relative error against exact softmax equals the reference's."""
    qh, kh, vh = (np.asarray(x) for x in _structured_qkv(
        np.random.default_rng(0), B=1, H=4, N=2048, D=32))
    S, block, nb = 2048, 32, 8
    lengths = np.full((1,), S, np.int32)
    q_pos = np.full((1, 1), S - 1, np.int32)
    qd = qh[:, :, -1:]
    exact = np.asarray(jmd.full_decode_attention(
        jnp.asarray(qd), jnp.asarray(kh), jnp.asarray(vh), jnp.asarray(lengths)))
    errs = []
    for fw, hier, md, cfg, conv in (
            ("jax", jh, jmd, JMraConfig(block_size=block, causal=True),
             jnp.asarray),
            ("torch", th, tmd, MraConfig(block_size=block), T)):
        cache = hier.build_hier_stream(conv(kh), conv(vh), block=block,
                                       nb=nb, levels=H)
        pyr = md.PyramidState(cache["pyr_k"][0], cache["pyr_v"][0],
                              hier.cache_upper_view(cache, 0))
        out = md.mra2_chunk_attention(
            conv(qd), cache["k_cache"], cache["v_cache"], conv(lengths),
            conv(q_pos), cfg, decode_blocks=4, pyramid=pyr,
            page_blocks=cache["page_blocks"])
        errs.append(float(np.linalg.norm(N(out) - exact)
                          / (np.linalg.norm(exact) + 1e-9)))
    assert errs[1] == pytest.approx(errs[0], rel=1e-5), errs
    assert 0.0 < errs[1] < 2.0
