"""Port parity: repro_torch.core.mra_decode + kernels/chunk_attn vs the JAX package.

The same numpy inputs go through the reference's jnp route (``use_kernel``
off: ``_select_pages`` + the tail of ``mra2_chunk_attention``, the oracle
DESIGN.md §11 pins the serving kernel to) and through the port on the CPU,
where ``chunk_attention_kernel`` takes its plain twin. Tolerances:
integers (page tables, counts, selected page sets) exactly; float page
statistics 1e-6; attention outputs atol 2e-5 / rtol 1e-5 (the reference's
own kernel-vs-jnp tolerance: sums run in another order in the two
frameworks); exact-softmax anchors atol 1e-4 (the reference's oracle
tolerance). The CUDA kernel's own comparison with its plain twin needs a
card and lives in the JAX-free ``tests/test_torch_cuda.py``; its inputs,
rebuilt there without JAX, are held here to the reference sweep's.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mra_decode as jmd
from repro.core.mra import MraConfig as JMraConfig
from repro_torch.core import mra_decode as tmd
from repro_torch.core.mra import MraConfig
from repro_torch.kernels import chunk_attn
from test_chunk_kernel import SWEEP, Case, make_case_inputs
from test_torch_cuda import REF_CASES, ref_case_inputs

ATOL, RTOL = 2e-5, 1e-5


def T(x):
    """numpy / jax array -> torch CPU tensor (None passes through)."""
    return None if x is None else torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _cfgs(case: Case):
    return (JMraConfig(block_size=case.b, causal=True, variant=case.variant),
            MraConfig(block_size=case.b, variant=case.variant))


def _dequant_pyramid(case: Case, inputs):
    """The engine's dataflow for an int8 cache: fp32 pyramid sums of the
    (dequantized) live tokens ride in, instead of the reference prelude's
    fallback that averages raw int8 codes (ROADMAP queue 3)."""
    q, k, v, lengths, q_pos, pb, ks, vs = inputs
    B, Hkv, S, D, b = case.B, case.Hkv, case.S, case.D, case.b
    nb = S // b
    pbt = pb if pb is not None else jmd.identity_page_table(B, nb)
    mask = np.asarray(jmd.paged_position_mask(lengths, pbt, S, b), np.float32)
    sums = []
    for x, sc in ((k, ks), (v, vs)):
        xf = np.asarray(x, np.float32) * np.asarray(sc)[..., None]
        sums.append((xf * mask[:, None, :, None]).reshape(
            B, Hkv, nb, b, D).sum(3, dtype=np.float32))
    return sums


def _both(case: Case, inputs, m, *, decode=False):
    q, k, v, lengths, q_pos, pb, ks, vs = inputs
    jcfg, tcfg = _cfgs(case)
    kw = dict(decode_blocks=m, page_blocks=pb, k_scale=ks, v_scale=vs)
    tkw = {k_: T(v_) for k_, v_ in kw.items() if k_ != "decode_blocks"}
    if ks is not None:
        ksum, vsum = _dequant_pyramid(case, inputs)
        kw["pyramid"] = jmd.PyramidState(jnp.asarray(ksum), jnp.asarray(vsum))
        tkw["pyramid"] = tmd.PyramidState(T(ksum), T(vsum))
    if decode:
        ref = jmd.mra2_decode_attention(q, k, v, lengths, jcfg, **kw)
        got = tmd.mra2_decode_attention(T(q), T(k), T(v), T(lengths), tcfg,
                                        decode_blocks=m, **tkw)
    else:
        ref = jmd.mra2_chunk_attention(q, k, v, lengths, q_pos, jcfg, **kw)
        got = tmd.mra2_chunk_attention(T(q), T(k), T(v), T(lengths), T(q_pos),
                                       tcfg, decode_blocks=m, **tkw)
    return N(got), np.asarray(ref)


# --------------------------------------------------------------------------- #
# page statistics, ring update, quantization
# --------------------------------------------------------------------------- #
def _page_table(r, B, nb):
    pb = r.integers(-1, 3 * nb, (B, nb)).astype(np.int32)
    pb[0] = np.arange(nb)  # one identity row
    return pb


@pytest.mark.parametrize("seed", range(4))
def test_page_stats_match_jax(seed):
    r = np.random.default_rng(seed)
    B, nb, b = 3, 5, 8
    pb = _page_table(r, B, nb)
    lengths = r.integers(0, 3 * nb * b, (B,)).astype(np.int32)
    np.testing.assert_array_equal(
        N(tmd.paged_block_counts(T(lengths), T(pb), b)),
        np.asarray(jmd.paged_block_counts(jnp.asarray(lengths),
                                          jnp.asarray(pb), b)))
    np.testing.assert_array_equal(
        N(tmd.paged_position_mask(T(lengths), T(pb), nb * b, b)),
        np.asarray(jmd.paged_position_mask(jnp.asarray(lengths),
                                           jnp.asarray(pb), nb * b, b)))
    np.testing.assert_array_equal(N(tmd.identity_page_table(B, nb)),
                                  np.asarray(jmd.identity_page_table(B, nb)))


@pytest.mark.parametrize("seed", range(4))
def test_ring_pyramid_update_matches_jax(seed):
    """Recycling, ownership moves and inactive slots (incl. pos = -1 of an
    idle empty slot, which floors to block -1 / page nb-1 in both)."""
    r = np.random.default_rng(seed)
    B, Hkv, nb, D, b = 4, 2, 4, 6, 8
    ks0 = r.standard_normal((B, Hkv, nb, D)).astype(np.float32)
    vs0 = r.standard_normal((B, Hkv, nb, D)).astype(np.float32)
    pb = _page_table(r, B, nb)
    kn = r.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = r.standard_normal((B, Hkv, D)).astype(np.float32)
    pos = np.array([b * 5, b * 5 + 3, -1, b * nb], np.int32)  # new block, mid, idle, wrap
    active = np.array([True, True, False, True])
    jp, jpb = jmd.ring_pyramid_update(
        jmd.PyramidState(jnp.asarray(ks0), jnp.asarray(vs0)), jnp.asarray(pb),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), b,
        active=jnp.asarray(active))
    tp, tpb = tmd.ring_pyramid_update(
        tmd.PyramidState(T(ks0), T(vs0)), T(pb), T(kn), T(vn), T(pos), b,
        active=T(active))
    np.testing.assert_array_equal(N(tpb), np.asarray(jpb))
    np.testing.assert_allclose(N(tp.k_sum), np.asarray(jp.k_sum), atol=1e-6)
    np.testing.assert_allclose(N(tp.v_sum), np.asarray(jp.v_sum), atol=1e-6)
    np.testing.assert_array_equal(N(tp.k_sum)[2], ks0[2])  # inactive untouched


def test_pyramid_append_matches_jax_and_drops_past_capacity():
    r = np.random.default_rng(0)
    B, Hkv, D, nb, block = 2, 2, 4, 4, 8
    kn = r.standard_normal((B, Hkv, D)).astype(np.float32)
    vn = r.standard_normal((B, Hkv, D)).astype(np.float32)
    pos = np.array([block + 3, nb * block], np.int32)
    jp = jmd.PyramidState.init(B, Hkv, nb, D).append(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), block)
    tp = tmd.PyramidState.init(B, Hkv, nb, D).append(T(kn), T(vn), T(pos),
                                                     block)
    np.testing.assert_allclose(N(tp.k_sum), np.asarray(jp.k_sum), atol=1e-6)
    np.testing.assert_allclose(N(tp.v_sum), np.asarray(jp.v_sum), atol=1e-6)
    assert np.abs(N(tp.k_sum)[1]).max() == 0.0  # dropped, not clamped


@pytest.mark.parametrize("seed", range(3))
def test_quantize_kv_matches_jax(seed):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((2, 3, 7, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0  # all-zero token: the 1e-6 scale floor
    jq, js = jmd.quantize_kv(jnp.asarray(x))
    tq, ts = tmd.quantize_kv(T(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(N(tq), np.asarray(jq))
    np.testing.assert_allclose(N(ts), np.asarray(js), rtol=1e-6, atol=0)


# --------------------------------------------------------------------------- #
# selection
# --------------------------------------------------------------------------- #
def _preludes(case: Case, inputs, m):
    q, k, v, lengths, q_pos, pb, ks, vs = inputs
    jcfg, tcfg = _cfgs(case)
    jpre = jmd._chunk_prelude(q, k, v, lengths, q_pos, jcfg, m, None, pb)
    tpre = tmd._chunk_prelude(T(q), T(k), T(v), T(lengths), T(q_pos), tcfg, m,
                              None, T(pb))
    return jpre, tpre


@pytest.mark.parametrize("case", SWEEP[::2], ids=lambda c: c.id)
@pytest.mark.parametrize("C", [1, 8])
def test_select_pages_matches_jax(case: Case, C: int):
    """Selected page sets and sel_ok equal the reference's lax.top_k exactly
    (prelude stats within 1e-6)."""
    inputs = make_case_inputs(case, C=C)
    m = 1 if case.coarse_only else case.m
    jpre, tpre = _preludes(case, inputs, m)
    for name in ("counts", "k_ds", "v_ds", "qg"):
        np.testing.assert_allclose(N(getattr(tpre, name)),
                                   np.asarray(getattr(jpre, name)), atol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(N(tpre.pb), np.asarray(jpre.pb))
    q_pos = inputs[4]
    js = jmd._select_pages(jpre, q_pos, m)
    ts = tmd._select_pages(tpre, T(q_pos), m)
    np.testing.assert_array_equal(N(ts.y_idx), np.asarray(js.y_idx))
    np.testing.assert_array_equal(N(ts.sel_ok), np.asarray(js.sel_ok))
    np.testing.assert_array_equal(N(ts.allowed), np.asarray(js.allowed))
    np.testing.assert_array_equal(N(ts.ownl), np.asarray(js.ownl))


def test_select_pages_ties_break_to_lowest_index():
    """All-equal coarse scores (zero queries): lax.top_k's order, which a
    plain torch.topk does not promise."""
    case = Case(S=128, b=16, m=5)
    q, k, v, lengths, q_pos, pb, ks, vs = make_case_inputs(case, C=3)
    q = jnp.zeros_like(q)
    jpre, tpre = _preludes(case, (q, k, v, lengths, q_pos, pb, ks, vs), 5)
    js = jmd._select_pages(jpre, q_pos, 5)
    ts = tmd._select_pages(tpre, T(q_pos), 5)
    np.testing.assert_array_equal(N(ts.y_idx), np.asarray(js.y_idx))


def test_pad_rows_select_nothing():
    """q_pos = -1 (a padded row) floors to block -1: no page is allowed, the
    selection is all-invalid and the row comes out as exact zeros."""
    case = Case(seed=2)
    q, k, v, lengths, q_pos, pb, ks, vs = make_case_inputs(case, C=4)
    q_pos = np.array(q_pos)
    q_pos[:, 2:] = -1
    _, tcfg = _cfgs(case)
    tpre = tmd._chunk_prelude(T(q), T(k), T(v), T(lengths), T(q_pos), tcfg,
                              case.m, None, None)
    sel = tmd._select_pages(tpre, T(q_pos), case.m)
    assert not N(sel.sel_ok)[:, :, :, 2:].any()
    assert N(sel.sel_ok)[:, :, :, :2].any()
    out = N(tmd.mra2_chunk_attention(T(q), T(k), T(v), T(lengths), T(q_pos),
                                     tcfg, decode_blocks=case.m))
    assert np.abs(out[:, :, 2:]).max() == 0.0


# --------------------------------------------------------------------------- #
# attention outputs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", SWEEP, ids=lambda c: c.id)
@pytest.mark.parametrize("mode", ["decode", "chunk"])
def test_chunk_attention_matches_jax(case: Case, mode: str):
    """Port (plain route) == reference jnp route across the 64-case sweep.

    int8 cases take the engine's dataflow (fp32 pyramid of the dequantized
    tokens): without a pyramid the reference averages raw int8 codes, its
    coarse scores land in code units (~1/scale too large) and a 1-ulp
    difference in them — XLA and PyTorch sum dot products in different
    orders — is amplified by exp() past any fp32 tolerance. That path is
    pinned by exact selection equality in ``test_select_pages_matches_jax``.
    """
    C = 1 if mode == "decode" else 8
    inputs = make_case_inputs(case, C=C)
    m = 1 if case.coarse_only else case.m
    got, ref = _both(case, inputs, m, decode=mode == "decode")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_oversubscribed_budget_matches_jax_and_exact():
    """m == nb with mostly-dead rings: padded selection entries add nothing."""
    case = Case(m=4, seed=5)
    q, k, v, _, _, pb, ks, vs = make_case_inputs(case, C=5)
    lengths = jnp.asarray([1, 17], jnp.int32)
    q_pos = jnp.maximum(lengths[:, None] - 5, 0) + jnp.arange(5)
    got, ref = _both(case, (q, k, v, lengths, q_pos, None, None, None), 4)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    exact = tmd.full_chunk_attention(T(q), T(k), T(v), T(lengths), T(q_pos))
    np.testing.assert_allclose(got[1], N(exact)[1], atol=1e-4)


def test_fresh_slot_zero_live_query_block_is_zero():
    case = Case(seed=13)
    q, k, v, _, _, _, _, _ = make_case_inputs(case, C=2)
    lengths = jnp.asarray([0, 37], jnp.int32)
    q_pos = jnp.asarray([[0, 1], [35, 36]], jnp.int32)
    got, ref = _both(case, (q, k, v, lengths, q_pos, None, None, None), case.m)
    assert np.abs(got[0]).max() == 0.0  # exact zeros, not stale cache
    assert np.abs(got[1]).max() > 0.0
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_full_budget_equals_exact_oracle():
    """Budget >= all live pages: MRA-2 == exact softmax (port and reference
    exact oracles agree too)."""
    case = Case(ragged=True, group=2, seed=7)
    q, k, v, lengths, q_pos, pb, ks, vs = make_case_inputs(case, C=8, min_len=8)
    _, tcfg = _cfgs(case)
    out = tmd.mra2_chunk_attention(T(q), T(k), T(v), T(lengths), T(q_pos),
                                   tcfg, decode_blocks=case.S // case.b)
    exact = tmd.full_chunk_attention(T(q), T(k), T(v), T(lengths), T(q_pos))
    np.testing.assert_allclose(N(out), N(exact), atol=1e-4)
    jexact = jmd.full_chunk_attention(q, k, v, lengths, q_pos)
    np.testing.assert_allclose(N(exact), np.asarray(jexact), atol=ATOL,
                               rtol=RTOL)


def test_full_decode_attention_matches_jax():
    case = Case(ragged=True, group=2, seed=9)
    q, k, v, lengths, _, _, _, _ = make_case_inputs(case, C=1)
    got = tmd.full_decode_attention(T(q), T(k), T(v), T(lengths))
    ref = jmd.full_decode_attention(q, k, v, lengths)
    np.testing.assert_allclose(N(got), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert np.abs(N(got)[0]).max() == 0.0  # the zero-length slot


def test_decode_equals_chunk_c1_and_coarse_decode():
    case = Case(ragged=True, group=2, seed=3)
    q, k, v, lengths, _, _, _, _ = make_case_inputs(case, C=1)
    _, tcfg = _cfgs(case)
    dec = tmd.mra2_decode_attention(T(q), T(k), T(v), T(lengths), tcfg,
                                    decode_blocks=2)
    chk = tmd.mra2_chunk_attention(T(q), T(k), T(v), T(lengths),
                                   T(lengths)[:, None] - 1, tcfg,
                                   decode_blocks=2)
    assert torch.equal(dec, chk)
    jcfg, _ = _cfgs(case)
    coarse = tmd.mra2_coarse_decode_attention(T(q), T(k), T(v), T(lengths),
                                              tcfg)
    jcoarse = jmd.mra2_coarse_decode_attention(q, k, v, lengths, jcfg)
    np.testing.assert_allclose(N(coarse), np.asarray(jcoarse), atol=ATOL,
                               rtol=RTOL)


def test_incremental_pyramid_matches_recomputed():
    """The engine's dataflow: pyramid sums ride in instead of being
    recomputed from the cache; same output."""
    case = Case(seed=11)
    q, k, v, lengths, _, _, _, _ = make_case_inputs(case, C=1)
    B, Hkv, S, D, b = case.B, case.Hkv, case.S, case.D, case.b
    nb = S // b
    mask = N(tmd.paged_position_mask(T(lengths), tmd.identity_page_table(B, nb),
                                     S, b)).astype(np.float32)
    kk, vv = np.asarray(k), np.asarray(v)
    pyr = tmd.PyramidState(
        T((kk * mask[:, None, :, None]).reshape(B, Hkv, nb, b, D).sum(3)),
        T((vv * mask[:, None, :, None]).reshape(B, Hkv, nb, b, D).sum(3)))
    _, tcfg = _cfgs(case)
    ref = tmd.mra2_decode_attention(T(q), T(k), T(v), T(lengths), tcfg,
                                    decode_blocks=2)
    out = tmd.mra2_decode_attention(T(q), T(k), T(v), T(lengths), tcfg,
                                    decode_blocks=2, pyramid=pyr)
    np.testing.assert_allclose(N(out), N(ref), atol=ATOL, rtol=RTOL)


# --------------------------------------------------------------------------- #
# the wrapper's contract on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["auto", "latency", "throughput"])
def test_cpu_wrapper_returns_the_plain_result(mode):
    """A CPU cache takes chunk_attention_ref (bit-identical) and launches no
    kernel."""
    case = Case(paged=True, quant=True, group=2, seed=21)
    q, k, v, lengths, q_pos, pb, ks, vs = make_case_inputs(case, C=5)
    _, tcfg = _cfgs(case)
    pre = tmd._chunk_prelude(T(q), T(k), T(v), T(lengths), T(q_pos), tcfg, 3,
                             None, T(pb))
    before = chunk_attn.chunk_attention_kernel.launches
    kw = dict(m=3, k_scale=T(ks), v_scale=T(vs), include_bg=True, mode=mode)
    got = chunk_attn.chunk_attention_kernel(pre, T(k), T(v), T(q_pos), **kw)
    ref = chunk_attn.chunk_attention_ref(pre, T(k), T(v), T(q_pos), **kw)
    assert torch.equal(got, ref)
    assert chunk_attn.chunk_attention_kernel.launches == before


def test_wrapper_rejects_upper_levels_and_bad_arguments():
    case = Case()
    q, k, v, lengths, q_pos, _, _, _ = make_case_inputs(case, C=1)
    _, tcfg = _cfgs(case)
    pre = tmd._chunk_prelude(T(q), T(k), T(v), T(lengths), T(q_pos), tcfg, 2,
                             None, None)
    with pytest.raises(ValueError, match="together"):
        chunk_attn.chunk_attention_kernel(pre, T(k), T(v), T(q_pos), m=2,
                                          k_scale=T(k)[..., 0])
    with pytest.raises(ValueError, match="kernel_mode"):
        chunk_attn.chunk_attention_kernel(pre, T(k), T(v), T(q_pos), m=2,
                                          mode="warp")
    with pytest.raises(NotImplementedError, match="draft_level"):
        tmd.mra2_chunk_attention(T(q), T(k), T(v), T(lengths), T(q_pos),
                                 dataclasses.replace(tcfg, draft_level=2))


def test_bad_shapes_raise_value_errors():
    case = Case()
    q, k, v, lengths, q_pos, _, _, _ = make_case_inputs(case, C=1)
    _, tcfg = _cfgs(case)
    with pytest.raises(ValueError, match="multiple of block_size"):
        tmd.mra2_chunk_attention(T(q), T(k)[:, :, :60], T(v)[:, :, :60],
                                 T(lengths), T(q_pos), tcfg, decode_blocks=2)
    with pytest.raises(ValueError, match="q_pos shape"):
        tmd.mra2_chunk_attention(T(q), T(k), T(v), T(lengths),
                                 torch.zeros((2, 3), dtype=torch.int32), tcfg)
    q3 = torch.cat([T(q), T(q)[:, :1]], dim=1)
    with pytest.raises(ValueError, match="KV heads"):
        tmd.mra2_chunk_attention(q3, T(k), T(v), T(lengths), T(q_pos), tcfg)


def test_resolve_kernel_mode():
    assert chunk_attn.resolve_kernel_mode("auto", 1) == "latency"
    assert chunk_attn.resolve_kernel_mode("auto", 5) == "throughput"
    assert chunk_attn.resolve_kernel_mode("latency", 5) == "latency"
    with pytest.raises(ValueError, match="kernel_mode"):
        chunk_attn.resolve_kernel_mode("fast", 1)


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("i", range(len(REF_CASES)))
def test_card_case_inputs_equal_the_reference_sweep_inputs(i, C):
    """``tests/test_torch_cuda.py`` rebuilds four points of the reference
    sweep without JAX (the card's machine has none): the same values, dtypes
    and shapes as ``make_case_inputs``, at the D = 16 its card test takes."""
    case = dataclasses.replace(REF_CASES[i], D=16)
    ref = make_case_inputs(Case(**dataclasses.asdict(case)), C=C)
    for got, want in zip(ref_case_inputs(case, C=C), ref):
        assert (got is None) == (want is None)
        if got is not None:
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
