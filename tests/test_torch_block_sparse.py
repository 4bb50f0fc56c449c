"""Port parity: repro_torch.kernels.block_sparse_attn vs the JAX package.

The block-sparse attention contract (numerator, row sums and stabilizer
``mt``; dq, dk, dv by recompute; dc ≡ 0) on the CPU, where the port's
autograd.Function takes its plain PyTorch versions:

  * the plain forward and backward against ``repro/kernels/ref.py`` and
    against the Pallas kernels in interpret mode, over
    ``tests/harness.py::OP_SWEEP`` (GQA groups x key masks x causal
    triangles, one invalid pair per row). Tolerance: atol 1e-5 / rtol 1e-5
    on the forward outputs and 1e-5 of the largest magnitude on gradients —
    the same fp32 arithmetic summed in another order;
  * the dq-only and dk/dv-only plain twins equal the whole plain backward;
  * the Function's hand-written backward against torch autograd through
    the plain forward (mt detached, as the contract makes it);
  * a query tile that no pair visits: numerator 0, row sum 0, mt = c;
  * the CSR pair lists order pairs exactly as the reference's
    ``ops._prepare`` / ``ops._prepare_kv`` do.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import OP_SWEEP, make_op_inputs, op_loss
from repro.kernels import ops as jops
from repro.kernels.ref import (
    block_sparse_attention_bwd_ref as jax_bwd_ref,
    block_sparse_attention_ref as jax_fwd_ref,
)
from repro_torch.kernels import block_sparse_attn as bsa

SCALE = 0.3
ATOL = RTOL = 1e-5


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _torch_inputs(case):
    return [_t(a) for a in make_op_inputs(case)]


def _cotangents(case, seed=11):
    r = np.random.default_rng(seed)
    BHG = case.BHKV * case.group
    return (r.standard_normal((BHG, case.n, case.d)).astype(np.float32),
            r.standard_normal((BHG, case.n)).astype(np.float32))


def _close(got, want, *, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _grad_close(got, want, tol=1e-5):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-6)
    assert err < tol, err


@pytest.mark.parametrize("case", OP_SWEEP, ids=lambda c: c.id)
def test_plain_fwd_bwd_match_reference_ref(case):
    q, k, v, c, x, y, fl, km = make_op_inputs(case)
    want = jax_fwd_ref(q, k, v, x, y, fl, c, km, scale=SCALE, block_size=case.b)
    tq, tk, tv, tc, tx, ty, tfl, tkm = _torch_inputs(case)
    got = bsa.block_sparse_attention_ref(tq, tk, tv, tx, ty, tfl, tc, tkm,
                                         scale=SCALE, block_size=case.b)
    for g, w in zip(got, want):
        _close(g, w)
    do, dr = _cotangents(case)
    want = jax_bwd_ref(q, k, v, c, x, y, fl, km, jnp.asarray(do),
                       jnp.asarray(dr), scale=SCALE, block_size=case.b)
    got = bsa.block_sparse_attention_bwd_ref(
        tq, tk, tv, tc, tx, ty, tfl, tkm, _t(do), _t(dr), scale=SCALE,
        block_size=case.b)
    for g, w in zip(got, want):
        _grad_close(g, w)


@pytest.mark.parametrize("case", OP_SWEEP[::3], ids=lambda c: c.id)
def test_plain_dq_and_dkv_parts_equal_whole_backward(case):
    """The dq-only and dk/dv-only plain twins (one per kernel) give exactly
    what the whole plain backward gives: the same ops on the same inputs."""
    tq, tk, tv, tc, tx, ty, tfl, tkm = _torch_inputs(case)
    do, dr = (_t(a) for a in _cotangents(case))
    args = (tq, tk, tv, tc, tx, ty, tfl, tkm, do, dr)
    kw = dict(scale=SCALE, block_size=case.b)
    dq, dk, dv = bsa.block_sparse_attention_bwd_ref(*args, **kw)
    assert torch.equal(bsa.block_sparse_attention_bwd_dq_ref(*args, **kw), dq)
    got_dk, got_dv = bsa.block_sparse_attention_bwd_dkv_ref(*args, **kw)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)


@pytest.mark.parametrize("case", OP_SWEEP, ids=lambda c: c.id)
def test_function_matches_pallas_interpret(case):
    """The autograd.Function (plain route on the CPU) against the Pallas
    kernels in interpret mode: forward outputs and the gradients of the
    harness's op loss (dc ≡ 0 on both sides)."""
    q, k, v, c, x, y, fl, km = make_op_inputs(case)

    def pallas(q, k, v, c):
        return jops.block_sparse_attention(q, k, v, c, x, y, fl, km,
                                           scale=SCALE, block_size=case.b,
                                           interpret=True)

    want = jax.jit(pallas)(q, k, v, c)
    want_g = jax.jit(jax.grad(op_loss(pallas), argnums=(0, 1, 2, 3)))(q, k, v, c)

    tq, tk, tv, tc, tx, ty, tfl, tkm = _torch_inputs(case)
    for t in (tq, tk, tv, tc):
        t.requires_grad_(True)
    got = bsa.block_sparse_attention(tq, tk, tv, tc, tx, ty, tfl, tkm,
                                     scale=SCALE, block_size=case.b)
    for g, w in zip(got, want):
        _close(g.detach(), w)
    o, rsum, _ = got
    (torch.sum(o * 0.3) + torch.sum(torch.sin(rsum))).backward()
    for g, w in zip((tq, tk, tv), want_g[:3]):
        _grad_close(g.grad, w)
    assert float(tc.grad.abs().max()) == 0.0 == float(jnp.abs(want_g[3]).max())


@pytest.mark.parametrize("case", OP_SWEEP[::3], ids=lambda c: c.id)
def test_function_backward_matches_torch_autograd(case):
    """The hand-written backward against torch autograd through the plain
    forward, whose mt is detached (the contract's gradient-transparent
    stabilizer). Tolerance 1e-5 of the largest gradient: same math."""
    tq, tk, tv, tc, tx, ty, tfl, tkm = _torch_inputs(case)
    do, dr = (_t(a) for a in _cotangents(case))

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        o, rsum, _ = fn(*leaves)
        return torch.autograd.grad((o * do).sum() + (rsum * dr).sum(), leaves)

    got = grads(lambda q, k, v: bsa.block_sparse_attention(
        q, k, v, tc, tx, ty, tfl, tkm, scale=SCALE, block_size=case.b))
    want = grads(lambda q, k, v: bsa.block_sparse_attention_ref(
        q, k, v, tx, ty, tfl, tc, tkm, scale=SCALE, block_size=case.b))
    for g, w in zip(got, want):
        _grad_close(g, w)


def test_unvisited_query_tile_is_zero_zero_floor():
    """A query tile that no pair visits: numerator 0, row sum 0, mt = c
    (ref.py:78-79), and dq 0 there."""
    case = OP_SWEEP[1]
    tq, tk, tv, tc, tx, ty, tfl, tkm = _torch_inputs(case)
    b = case.b
    tx = torch.where(tx == 2, 1, tx)  # no pair of any row visits block 2
    tq.requires_grad_(True)
    o, rsum, mt = bsa.block_sparse_attention(tq, tk, tv, tc, tx, ty, tfl, tkm,
                                             scale=SCALE, block_size=b)
    rows = slice(2 * b, 3 * b)
    assert float(o.detach()[:, rows].abs().max()) == 0.0
    assert float(rsum.detach()[:, rows].abs().max()) == 0.0
    assert torch.equal(mt[:, rows], tc[:, 2:3].expand(-1, b))
    (o.sum() + rsum.sum()).backward()
    assert float(tq.grad[:, rows].abs().max()) == 0.0


@pytest.mark.parametrize("case", OP_SWEEP[::2], ids=lambda c: c.id)
def test_pair_lists_follow_reference_prepare(case):
    """group_by_query / group_by_key sort exactly as ops._prepare /
    ops._prepare_kv, and each tile's CSR range holds only that tile."""
    _, _, _, _, x, y, fl, _ = make_op_inputs(case)
    nb = case.n // case.b
    xs, ys, fls, _ = jops._prepare(x, y, fl)
    pq = bsa.group_by_query(_t(x), _t(y), _t(fl), nb)
    for g, w in zip((pq.x, pq.y, pq.flags), (xs, ys, fls)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    rows, xk, yk, _, fk = jops._prepare_kv(x, y, fl, case.group)
    pk = bsa.group_by_key(_t(x), _t(y), _t(fl), case.group, nb)
    for g, w in zip((pk.rows, pk.x, pk.y, pk.flags), (rows, xk, yk, fk)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for ids, ptr in ((pq.x, pq.ptr), (pk.y, pk.ptr)):
        assert ptr.dtype == torch.int32 and int(ptr[:, -1].min()) == ids.shape[1]
        for r in range(ids.shape[0]):
            for blk in range(nb):
                seg = ids[r, int(ptr[r, blk]):int(ptr[r, blk + 1])]
                assert bool((seg == blk).all())


@pytest.mark.parametrize("tail", [(), (5,), (4, 3)], ids=["rows", "vec", "blk"])
def test_segment_sum_equals_scatter_add(tail):
    """The plain twin's fixed-order segment sum (a one-hot product) equals
    ``scatter_add`` over the same block ids, repeated ids included, within
    1e-6; it runs in one order, so it reruns bitwise."""
    r = np.random.default_rng(7)
    R, m, nb = 6, 9, 4
    values = torch.from_numpy(r.standard_normal((R, m) + tail, np.float32))
    idx = torch.from_numpy(r.integers(0, nb, (R, m)).astype(np.int32))
    want = values.new_zeros((R, nb) + tail).scatter_add(
        1, idx.long().reshape(R, m, *([1] * len(tail))).expand_as(values),
        values)
    got = bsa._segment_add(values, idx, nb)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    assert torch.equal(got, bsa._segment_add(values, idx, nb))
