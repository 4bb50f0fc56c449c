"""Port parity: repro_torch.core.mra vs repro.core.mra (full-sequence MRA-2).

The same numpy inputs go through the reference and the port on the CPU,
where the port's high-resolution term takes the block-sparse kernel's plain
version:

  * over ``tests/harness.py::SWEEP`` (causal x GQA x padded x variant, N not
    a multiple of b): the forward against the reference's jnp route
    (``use_kernel=False``) at atol 2e-5 / rtol 1e-5, the gradients of a
    fixed random cotangent against ``jax.grad`` at 1e-5 of the largest
    gradient (fp32 sums in another order), and the selected ``x_idx`` /
    ``y_idx`` / ``sel_valid`` exactly equal;
  * a full budget equals ``full_attention`` (exact softmax);
  * equal coarse scores pin ``lax.top_k``'s lowest-index tie-break;
  * with a non-empty background (budget below the grid), gradients against
    the reference's kernel route (the contract the port implements). At a
    token whose fine max lies below the background max, ``c_bg == mt`` and
    ``jnp.minimum(c_bg - mt, 0)`` (reference mra.py:282) passes half the
    gradient, while the reference's jnp route (mra.py:371) passes all of
    it; the port follows the kernel route (ROADMAP §3).
"""
from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from harness import SWEEP, make_inputs
from repro.core.mra import MraConfig as JMraConfig
from repro.core.mra import full_attention as jax_full
from repro.core.mra import mra2_attention as jax_mra2
from repro.kernels.ref import block_sparse_attention_ref as jax_bsa_ref
from repro_torch.core.mra import (
    MraConfig,
    _pad_to_multiple,
    full_attention,
    kernel_pairs,
    mra2_attention,
    select_blocks,
)


def _configs(case, **kw):
    common = dict(block_size=case.block_size, variant=case.variant,
                  causal=case.causal,
                  blocks_per_row=kw.pop("blocks_per_row", case.blocks_per_row))
    return JMraConfig(**common, **kw), MraConfig(**common)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _port_grads(q, k, v, km, cfg, ct):
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = mra2_attention(*leaves, cfg, key_mask=_t(km))
    (out * _t(ct)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_out_grads(q, k, v, km, cfg, ct):
    """The reference's output and the gradients of sum(out * ct), jitted."""
    def loss(q, k, v, km):
        out = jax_mra2(q, k, v, cfg, key_mask=km)
        return jnp.sum(out * ct), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v, km)
    return np.asarray(out), grads


def _max_rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("case", SWEEP, ids=lambda c: c.id)
def test_mra2_matches_reference_jnp_route(case):
    q, k, v, km = make_inputs(case)
    jcfg, tcfg = _configs(case)
    ct = np.random.default_rng(case.seed + 100).standard_normal(
        q.shape).astype(np.float32)
    want, want_grads = _jax_out_grads(q, k, v, km, jcfg, ct)
    got, grads = _port_grads(q, k, v, km, tcfg, ct)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    for g, w in zip(grads, want_grads):
        assert _max_rel(g, w) < 1e-5


def _reference_selection(q, k, v, km, jcfg):
    """x_idx, y_idx, flags and c of the reference's kernel route, caught
    at its call of ops.block_sparse_attention (traced once under jit and
    returned as outputs)."""
    def run(q, k, v, km):
        seen = {}

        def spy(q, k, v, c, x_idx, y_idx, flags, key_mask=None, *, scale,
                block_size, **_):
            seen.update(x=x_idx, y=y_idx, flags=flags, c=c)
            return jax_bsa_ref(q, k, v, x_idx, y_idx, flags, c, key_mask,
                               scale=scale, block_size=block_size)

        with mock.patch.object(jops, "block_sparse_attention", spy):
            jax_mra2(q, k, v, dataclasses.replace(jcfg, use_kernel=True),
                     key_mask=km)
        return seen

    return {n: np.asarray(a) for n, a in jax.jit(run)(q, k, v, km).items()}


def _port_selection(q, k, v, km, cfg):
    q, k, v = (_t(a) for a in (q, k, v))
    B, Hq, N, D = q.shape
    Hkv = k.shape[1]
    b = cfg.block_size
    q, k, v = (_pad_to_multiple(t, b, 2)[0] for t in (q, k, v))
    n = q.shape[2]
    mask = (torch.arange(n) < N)[None].expand(B, n) if km is None else \
        _pad_to_multiple(_t(km), b, 1)[0]
    sel = select_blocks(q.reshape(B, Hkv, Hq // Hkv, n, D), k, v, mask, cfg,
                        1.0 / D**0.5)
    return sel, kernel_pairs(sel, cfg.causal)


@pytest.mark.parametrize("case", SWEEP, ids=lambda c: c.id)
def test_selection_exactly_equal(case):
    q, k, v, km = make_inputs(case)
    jcfg, tcfg = _configs(case)
    want = _reference_selection(q, k, v, km, jcfg)
    sel, (c, x, y, flags) = _port_selection(q, k, v, km, tcfg)
    BHG, m = want["x"].shape
    assert np.array_equal(x.numpy(), want["x"])
    assert np.array_equal(y.numpy(), want["y"])
    assert np.array_equal(flags.numpy(), want["flags"])
    assert np.array_equal(sel.sel_valid.reshape(BHG, m).numpy(),
                          (want["flags"] & 1) == 1)
    np.testing.assert_allclose(c.numpy(), want["c"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("variant", ["full", "sparse"])
def test_full_budget_equals_full_attention(causal, variant):
    r = np.random.default_rng(3)
    q = r.standard_normal((2, 4, 64, 16)).astype(np.float32)
    k = r.standard_normal((2, 2, 64, 16)).astype(np.float32)
    v = r.standard_normal((2, 2, 64, 16)).astype(np.float32)
    cfg = MraConfig(block_size=16, blocks_per_row=8, variant=variant,
                    causal=causal)
    got = mra2_attention(_t(q), _t(k), _t(v), cfg).numpy()
    want = full_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        want, np.asarray(jax_full(q, k, v, causal=causal)), atol=1e-5,
        rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_equal_coarse_scores_pick_lowest_index(causal):
    """Every key block is the same block and every query block too, so all
    coarse scores tie exactly: the selection takes the lowest flat indices
    (x·nb + y) beyond the forced diagonal, as lax.top_k.
    Small integer inputs keep every mean and dot exact in fp32, whatever
    the order of the sums."""
    r = np.random.default_rng(4)
    b, nb = 8, 6

    def ints(*shape):
        return r.integers(-2, 3, shape).astype(np.float32)

    k = np.tile(ints(1, 1, b, 8), (1, 1, nb, 1))
    v = ints(1, 1, nb * b, 8)
    q = np.tile(ints(1, 2, b, 8), (1, 1, nb, 1))
    case = SWEEP[0].__class__(causal=causal, block_size=b, blocks_per_row=2,
                              N=nb * b, D=8, B=1, Hkv=1, group=2)
    jcfg, tcfg = _configs(case)
    want = _reference_selection(q, k, v, None, jcfg)
    sel, (_, x, y, _) = _port_selection(q, k, v, None, tcfg)
    assert np.array_equal(x.numpy(), want["x"])
    assert np.array_equal(y.numpy(), want["y"])
    grid = np.zeros((2, nb, nb), bool)
    for row in range(2):
        grid[row, x[row].numpy(), y[row].numpy()] = sel.sel_valid.reshape(
            2, -1)[row].numpy()
    for row in range(2):  # beyond the forced diagonal: lowest (x, y) first
        off = [(i, j) for i in range(nb) for j in range(nb)
               if i != j and (j <= i or not causal)]
        m = x.shape[1] - nb
        assert [p for p in off if grid[row][p]] == off[:m]


def _ref_forward(q, k, v, x_idx, y_idx, first, flags, c, km, *, scale,
                 block_size, interpret=False):
    """ops' Pallas forward replaced by its ref.py oracle (the two are held
    equal in tests/test_torch_block_sparse.py and the reference's suites)."""
    return jax_bsa_ref(q, k, v, x_idx, y_idx, flags, c, km, scale=scale,
                       block_size=block_size)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group", [1, 2])
def test_background_gradients_match_reference_kernel_route(causal, group):
    """Budget 2 of 8 blocks per row: a non-empty coarse background. The
    forward against the reference's jnp route, the gradients against its
    kernel route (``use_kernel=True`` with the jnp backward, and ref.py in
    place of the Pallas forward)."""
    r = np.random.default_rng(5 + group)
    q = r.standard_normal((2, 2 * group, 128, 16)).astype(np.float32)
    k = r.standard_normal((2, 2, 128, 16)).astype(np.float32)
    v = r.standard_normal((2, 2, 128, 16)).astype(np.float32)
    ct = r.standard_normal(q.shape).astype(np.float32)
    common = dict(block_size=16, blocks_per_row=2, causal=causal)
    got, grads = _port_grads(q, k, v, None, MraConfig(**common), ct)
    want, _ = _jax_out_grads(q, k, v, None, JMraConfig(**common), ct)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    kernel_route = JMraConfig(**common, use_kernel=True, kernel_bwd="jnp")
    with mock.patch.object(jops, "block_sparse_attention_fwd", _ref_forward):
        _, want_grads = _jax_out_grads(q, k, v, None, kernel_route, ct)
    for g, w in zip(grads, want_grads):
        assert _max_rel(g, w) < 1e-5


def test_reference_routes_differ_at_background_ties():
    """The smallest case of the reference difference noted above (ROADMAP
    §3): the reference's own jnp and kernel routes give gradients more than
    1e-4 of the largest apart; the port sits on the kernel route."""
    r = np.random.default_rng(0)
    q = r.standard_normal((2, 4, 128, 16)).astype(np.float32)
    k = r.standard_normal((2, 2, 128, 16)).astype(np.float32)
    v = r.standard_normal((2, 2, 128, 16)).astype(np.float32)
    ct = r.standard_normal(q.shape).astype(np.float32)
    common = dict(block_size=16, blocks_per_row=2, causal=True)
    _, grads = _port_grads(q, k, v, None, MraConfig(**common), ct)
    _, jnp_route = _jax_out_grads(q, k, v, None, JMraConfig(**common), ct)
    with mock.patch.object(jops, "block_sparse_attention_fwd", _ref_forward):
        _, kernel_route = _jax_out_grads(q, k, v, None, JMraConfig(
            **common, use_kernel=True, kernel_bwd="jnp"), ct)
    assert _max_rel(kernel_route[0], jnp_route[0]) > 1e-4
    assert _max_rel(grads[0], kernel_route[0]) < 1e-5
    assert _max_rel(grads[0], jnp_route[0]) > 1e-4
