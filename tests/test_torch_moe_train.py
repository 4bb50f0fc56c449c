"""Port parity: training the MoE family (granite-moe-3b-a800m) vs the reference.

On the CPU, fp32, the reference's weights carried over by ``params_from_jax``
and batches from its data pipeline:

  * ``moe_block``'s backward (every expert weight, the router and the input,
    through the combine, the dispatch and both aux losses) against
    ``jax.grad`` of the reference's ``moe_block``: within 1e-6 of each
    leaf's largest gradient, with capacity drops absent (capacity_factor =
    E / top_k) and present, and with tied router columns;
  * the whole smoke model's ``loss_fn`` (rtol 1e-6) and every parameter
    gradient against ``jax.value_and_grad`` of the reference's, in the same
    three cases. With the smoke config's two layers the gradients agree
    within 1e-4 of each leaf's largest entry, not 1e-5 (worst leaf 4.7e-5
    to 5.8e-5 in the four cases, 13-14 of 23 leaves above 1e-5): granite
    has no qk-norm, and with random smoke weights the second layer's
    attention scores amplify the first's fp32 rounding — the dense qwen3
    smoke gives 1.3e-6 with its qk-norm and 2.5e-5 without it, on the same
    route and inputs. Cut to one layer, every leaf agrees within 1e-5
    (worst 1.9e-6 to 2.2e-6), and ``moe_block`` alone within 5e-7;
  * granite at full width (d_model 1536, 40 experts top-8, head dim 64,
    b = 128) cut to two layers, seq 256: loss and aux loss within 1e-5 and
    the gradient's global norm within 1e-4 of the reference's — the
    preset's own widths, where its initialization (no qk-norm) grows the
    gradient several-fold a layer;
  * one ``make_train_step`` step (two microbatches, AdamW with clipping)
    against the reference's: loss, aux loss and grad norm within 1e-5;
    999 in 1000 updated entries within ``_step_tol`` and every one within
    lr (an entry whose gradient is near 0 may flip its first update);
  * ``remat="dots"`` and ``"full"`` give ``"none"``'s loss and gradients;
    the products ``"dots"`` keeps on one smoke layer (dense and MoE) are
    those with no batch dimension in the reference layer's jaxpr, as an
    unordered (rows, columns) multiset; the products the reference's
    ``print_saved_residuals`` reports are among them, by size, and for the
    MoE layer they are all of them (q, k, v, o, router logits). On the
    dense layer JAX also drops the gate product (it keeps silu of it, of
    the same size) and the MLP's down projection, which its backward never
    reads; torch's selective checkpoint keeps every product it names until
    the recompute.

The reference runs its kernel route (ref.py for the Pallas forward, jnp
backward), which is the contract the port implements; its jnp route parts
from it where a token's fine max ties the background max (ROADMAP §3): on
these inputs its gradients differ from the kernel route's by 3.9e-4.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import math
import re
from collections import Counter
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
from jax.ad_checkpoint import print_saved_residuals
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_jax, tree_leaves
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import TrainConfig, make_train_step
from test_torch_train import _kernel_route, _max_rel, _shapes, _step_tol

ARCH = "granite-moe-3b-a800m"
# capacity_factor: E / top_k = 2.5 drops nothing; 0.5 drops; tie: router
# columns 1 and 2 equal in every layer, so each token's probabilities of
# experts 1 and 2 tie exactly
CASES = [dict(cf=2.5, tie=False), dict(cf=0.5, tie=False),
         dict(cf=2.5, tie=True), dict(cf=0.5, tie=True)]


def _ids(case):
    return f"cf{case['cf']}" + ("-tie" if case["tie"] else "")


def _configs(cf, **kw):
    jcfg = jax_smoke(ARCH, activ_dtype="float32", attn_use_kernel=True,
                     attn_kernel_bwd="jnp", **kw)
    tcfg = get_smoke_config(ARCH, activ_dtype="float32", **kw)
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=cf)),
            tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=cf)))


def _weights(jcfg, tcfg, tie, seed=0):
    jp = jax.device_get(jax_init(jax_get_model(jcfg).param_specs(jcfg),
                                 jax.random.PRNGKey(seed)))
    if tie:
        for lp in jp["layers"]:
            r = np.array(lp["moe"]["router"])
            r[:, 2] = r[:, 1]
            lp["moe"]["router"] = r
    tp = params_from_jax(jp, tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return jp, tp


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_moe_block_gradients_match_jax(case):
    jcfg, tcfg = _configs(case["cf"])
    jp, tp = _weights(jcfg, tcfg, case["tie"])
    jm, tm = jp["layers"][0]["moe"], tp["layers"][0]["moe"]
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    w = r.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe_block(x, p, jcfg)
        return jnp.sum(out * w) + 3 * aux["load_balance"] + 5 * aux["router_z"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jm, jnp.asarray(x))
    jout, jaux = JM.moe_block(jnp.asarray(x), jm, jcfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = TM.moe_block(xt, tm, tcfg)
    tl = ((out * torch.from_numpy(w)).sum() + 3 * aux["load_balance"]
          + 5 * aux["router_z"])
    grads = torch.autograd.grad(tl, tree_leaves(tm) + [xt])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]),
                                   rtol=1e-6)
    want = jax.tree_util.tree_leaves(jgp) + [jgx]
    assert len(want) == len(grads)
    for g, wnt in zip(grads, want):
        assert _max_rel(g.numpy(), wnt) < 1e-6


def _loss_and_gradients(case, tol, **kw):
    jcfg, tcfg = _configs(case["cf"], **kw)
    jp, tp = _weights(jcfg, tcfg, case["tie"])
    jshape, _ = _shapes()
    batch = jax_make_batch(jcfg, jshape, step=1, seed=3)

    def loss(p):
        return JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    with _kernel_route():
        (jl, jmet), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    tl, tmet = TT.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["aux_loss"].detach()),
                               float(jmet["aux_loss"]), rtol=1e-6)
    assert float(tmet["aux_loss"].detach()) > 0
    want = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert _max_rel(g.numpy(), w) < tol


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_every_gradient_match_jax(case):
    _loss_and_gradients(case, tol=1e-4)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_one_layer_loss_and_every_gradient_match_jax(case):
    """One smoke layer: no later attention amplifies the first's rounding,
    and every leaf agrees within 1e-5."""
    _loss_and_gradients(case, tol=1e-5, num_layers=1)


def test_full_width_layers_match_reference():
    kw = dict(num_layers=2, activ_dtype="float32", remat="none",
              scan_layers=False)
    jcfg = jax_get_config(ARCH, attn_use_kernel=True, attn_kernel_bwd="jnp",
                          **kw)
    tcfg = get_config(ARCH, **kw)
    jp, tp = _weights(jcfg, tcfg, tie=False)
    jshape, _ = _shapes(seq=256, batch=1)
    batch = jax_make_batch(jcfg, jshape, step=0, seed=0)

    def loss(p):
        return JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    with _kernel_route():
        (jl, jmet), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    del jp
    tl, tmet = TT.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads = torch.autograd.grad(tl, tree_leaves(tp))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux_loss"].detach()),
                               float(jmet["aux_loss"]), rtol=1e-5)
    want = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                       for g in jax.tree_util.tree_leaves(jax.device_get(jg))))
    got = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_step_matches_reference():
    jcfg, tcfg = _configs(0.5)
    jp, tp = _weights(jcfg, tcfg, tie=False)
    jshape, _ = _shapes(batch=4)
    batch = jax_make_batch(jcfg, jshape, step=0, seed=0)
    lr = 1e-3
    jstep = jax_make_train_step(jcfg, JTrainConfig(steps=10, microbatches=2),
                                JAdamW(), jax_cosine(lr, 2, 10))
    with _kernel_route():
        jp2, _, jmet = jax.jit(jstep)(jp, JAdamW().init(jp), {
            k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tcfg, TrainConfig(steps=10, microbatches=2),
                            AdamW(), cosine_schedule(lr, 2, 10))
    tp2, ts, tmet = tstep(tp, AdamW().init(tp), {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert ts.step == 1
    for key in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)
    # the first AdamW update is about ±lr an entry whatever |g| is, except
    # where |g| is near eps; there gradients that agree within 1e-4 of the
    # leaf's largest (see the module note) may move it by a part of lr
    lr_now = float(jmet["lr"])
    for g, w in zip(tree_leaves(tp2),
                    jax.tree_util.tree_leaves(jax.device_get(jp2))):
        diff = np.abs(g.detach().numpy() - np.asarray(w))
        assert (diff <= _step_tol(lr_now)).mean() >= 0.999
        assert diff.max() <= lr_now


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_none(remat):
    """Recomputing the layers (all of it, or all but the products) changes
    neither the loss nor any gradient of the MoE model."""
    _, tcfg = _configs(0.5)
    _, tshape = _shapes()
    r = np.random.default_rng(2)
    toks = torch.as_tensor(r.integers(0, tcfg.vocab, (2, tshape.seq_len)))
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    out = []
    for policy in ("none", remat):
        cfg = tcfg.replace(remat=policy)
        _, tp = _weights(*_configs(0.5), tie=False, seed=1)
        loss, _ = TT.loss_fn(tp, cfg, batch)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(tp))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def _no_batch_products(jaxpr):
    """Unordered (rows, columns) of every dot_general with no batch
    dimension in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, _) = eqn.params["dimension_numbers"]
            if not lb:
                ls, rs = (v.aval.shape for v in eqn.invars[:2])
                out.append(tuple(sorted((
                    math.prod(d for i, d in enumerate(ls) if i not in lc),
                    math.prod(d for i, d in enumerate(rs) if i not in rc)))))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += _no_batch_products(sub)
    return out


def _port_products(op, args):
    """Unordered (rows, columns) of a product the port's policy keeps."""
    aten = torch.ops.aten
    a, b = (args[1], args[2]) if op is aten.addmm.default else args[:2]
    return tuple(sorted((a.shape[-2], b.shape[-1])))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", ARCH])
def test_dots_keeps_the_products_the_reference_policy_saves(arch):
    jcfg = jax_smoke(arch, activ_dtype="float32", remat="dots")
    tcfg = get_smoke_config(arch, activ_dtype="float32", remat="dots")
    jp = jax.device_get(jax_init(jax_get_model(jcfg).param_specs(jcfg),
                                 jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, tcfg, device="cpu")
    x = np.random.default_rng(0).standard_normal(
        (2, 64, tcfg.d_model)).astype(np.float32)
    layer = functools.partial(JT._layer_fwd, cfg=jcfg, key_mask=None)
    want = Counter(_no_batch_products(jax.make_jaxpr(
        lambda lp, x: layer(x, lp))(jp["layers"][0], x).jaxpr))
    body = JL.remat_wrap(layer, jcfg)

    def jloss(lp, x):
        y, aux = body(x, lp)
        return jnp.sum(y) + sum(aux.values(), jnp.zeros(()))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(jloss, jp["layers"][0], jnp.asarray(x))
    jax_saved = Counter(
        math.prod(int(d) for d in re.match(r"\w+\[([\d,]*)\]", ln)
                  .group(1).split(",") if d)
        for ln in buf.getvalue().splitlines() if " output of " in ln)

    kept, policy = [], TL._dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == TL.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.append(_port_products(op, args))
        return out

    lp = tp["layers"][0]
    for t in tree_leaves(lp):
        t.requires_grad_(True)
    with mock.patch.object(TL, "_dots_policy", spy):
        y, aux = TL.remat_wrap(TT._layer_fwd, tcfg)(
            torch.from_numpy(x), lp, tcfg, None)
        loss = y.sum() + sum(aux.values(), torch.zeros(()))
        torch.autograd.grad(loss, tree_leaves(lp))
    assert Counter(kept) == want
    sizes = Counter(a * b for a, b in kept)
    assert not jax_saved - sizes  # every product JAX keeps, the port keeps
    if arch == ARCH:
        assert jax_saved == sizes
