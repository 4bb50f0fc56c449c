"""Port parity: the training slice of repro_torch vs the JAX package.

At the qwen3-1.7b smoke config with fp32 activations, the reference's
weights carried over by ``params_from_jax`` and batches from both data
pipelines, on the CPU:

  * ``forward`` logits (atol 1e-4, the exact-oracle tolerance of a
    two-layer fp32 model summed in other orders), ``loss_fn`` (rtol 1e-6)
    and every parameter gradient (1e-5 of the leaf's largest gradient)
    against ``jax.value_and_grad``;
  * one ``AdamW.update`` and ``cosine_schedule`` on the same numpy inputs
    (rtol 1e-6: the same fp32 formula);
  * ``make_batch`` bit-identical;
  * one reference ``make_train_step`` step (two microbatches) against the
    port's: loss, grad norm and updated parameters (see ``_step_tol``);
  * checkpoint resume bit-identical: 4 steps equal 2 steps, a crash,
    restore, then 2 more.

The reference runs its kernel route (``attn_use_kernel``, jnp backward,
ref.py in place of the Pallas forward: held equal to it in
test_torch_block_sparse.py), which is the contract the port implements;
its jnp route differs in gradient where a token's fine max ties the
background max (tests/test_torch_mra.py, ROADMAP §3).
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
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.data.pipeline import make_batch as jax_make_batch
from repro.kernels.ref import block_sparse_attention_ref as jax_bsa_ref
from repro.models import get_model, init_params as jax_init
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.data import make_batch
from repro_torch.models import transformer as TT
from repro_torch.models.params import (
    init_params,
    params_from_jax,
    tree_leaves,
)
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import TrainConfig, make_train_step, train

ARCH = "qwen3-1.7b"
SEQ, BATCH = 64, 2  # 4 blocks of 16, budget 8 of 10: a coarse background


def _ref_forward(q, k, v, x_idx, y_idx, first, flags, c, km, *, scale,
                 block_size, interpret=False):
    return jax_bsa_ref(q, k, v, x_idx, y_idx, flags, c, km, scale=scale,
                       block_size=block_size)


def _kernel_route():
    """Trace the reference's kernel route with ref.py as its forward."""
    return mock.patch.object(jops, "block_sparse_attention_fwd", _ref_forward)


def _configs(**kw):
    kw.setdefault("activ_dtype", "float32")
    jcfg = jax_smoke(ARCH, attn_use_kernel=True, attn_kernel_bwd="jnp", **kw)
    return jcfg, get_smoke_config(ARCH, **kw)


def _shapes(seq=SEQ, batch=BATCH):
    return (dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=seq,
                                global_batch=batch),
            dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                global_batch=batch))


def _weights(jcfg, tcfg, seed=0):
    jp = jax_init(get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return jp, tp


def _max_rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("pad_heads", [0, 8])
def test_forward_loss_and_gradients_match_reference(pad_heads):
    """pad_heads=8 pads the 4 query heads to 8 (masked) and expands the 2 KV
    heads to 8 slots, as the reference's TP padding does."""
    jcfg, tcfg = _configs(pad_attn_heads_to=pad_heads)
    jp, tp = _weights(jcfg, tcfg)
    jshape, _ = _shapes()
    batch = jax_make_batch(jcfg, jshape, step=1, seed=3)

    def loss(p):
        return JT.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    with _kernel_route():
        (jl, jmet), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        jlogits, _ = jax.jit(lambda p: JT.forward(p, jcfg, {
            "tokens": jnp.asarray(batch["tokens"])}))(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tmet = TT.loss_fn(tp, tcfg, tb)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    with torch.no_grad():
        tlogits, aux = TT.forward(tp, tcfg, {"tokens": tb["tokens"]})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4)
    assert float(aux) == 0.0 == float(jmet["aux_loss"])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["nll"].detach()), float(jmet["nll"]),
                               rtol=1e-6)
    jleaves = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(jleaves) == len(tg)
    for g, w in zip(tg, jleaves):
        assert _max_rel(g.numpy(), w) < 1e-5


def test_remat_full_matches_none():
    """Recomputing each layer in the backward, all of it ("full") or all
    but the products with no batch dimension ("dots"), changes no value."""
    _, tcfg = _configs()
    _, tshape = _shapes()
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(tcfg, tshape, step=0).items()}
    out = []
    for remat in ("none", "full", "dots"):
        cfg = tcfg.replace(remat=remat)
        params = init_params(cfg, seed=1, device="cpu")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, _ = TT.loss_fn(params, cfg, batch)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    for other in out[1:]:
        assert torch.equal(out[0][0], other[0])
        for a, b in zip(out[0][1], other[1]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_adamw_and_cosine_match_reference():
    r = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}

    def tree(scale):
        return jax.tree.map(lambda s: (scale * r.standard_normal(s)).astype(
            np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))

    params, grads, mu, nu = tree(1.0), tree(3.0), tree(0.1), tree(0.1)
    nu = jax.tree.map(np.abs, nu)
    jlr = jax_cosine(1e-2, 3, 20)
    tlr = cosine_schedule(1e-2, 3, 20)
    for step in (0, 2, 3, 7, 19, 25):
        np.testing.assert_allclose(float(tlr(step)), float(jlr(jnp.int32(step))),
                                   rtol=1e-6)
    jopt, topt = JAdamW(), AdamW()
    jstate = jopt.init(params)._replace(step=jnp.int32(4), mu=mu, nu=nu)
    jp, js, jn = jopt.update(grads, jstate, params, jlr(jnp.int32(4)))

    def tt(t):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)

    tstate = topt.init(tt(params))._replace(step=4, mu=tt(mu), nu=tt(nu))
    tp, ts, tn = topt.update(tt(grads), tstate, tt(params), tlr(4))
    assert ts.step == 5 == int(js.step)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("seq,batch,step,seed", [(64, 2, 0, 0), (33, 3, 5, 7),
                                                 (300, 1, 2, 1)])
def test_make_batch_bit_identical(seq, batch, step, seed):
    jcfg, tcfg = _configs()
    jshape, tshape = _shapes(seq, batch)
    want = jax_make_batch(jcfg, jshape, step=step, seed=seed)
    got = make_batch(tcfg, tshape, step=step, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
    want = jax_make_batch(jcfg, jshape, step=step, seed=seed, shard=1,
                          num_shards=2, batch_override=2)
    got = make_batch(tcfg, tshape, step=step, seed=seed, shard=1,
                     num_shards=2, batch_override=2)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _step_tol(lr):
    """Updated-parameter tolerance of one AdamW step: 1e-2·lr. Its first
    update is lr·g/(|g| + eps), about ±lr per entry and flat in g except
    where |g| is within a few eps of 0; there a gradient that agrees to
    1e-5 of the leaf's largest entry may still move the update by a small
    part of lr (1.2e-3·lr at most on these inputs, in 2 of 32768 entries)."""
    return 1e-2 * lr


def test_train_step_matches_reference():
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, tcfg)
    jshape, tshape = _shapes(batch=4)
    batch = jax_make_batch(jcfg, jshape, step=0, seed=0)
    lr = 1e-3
    jstep = jax_make_train_step(jcfg, JTrainConfig(steps=10, microbatches=2),
                                JAdamW(), jax_cosine(lr, 2, 10))
    with _kernel_route():
        jp2, _, jmet = jax.jit(jstep)(jp, JAdamW().init(jp), {
            k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tcfg, TrainConfig(steps=10, microbatches=2),
                            AdamW(), cosine_schedule(lr, 2, 10))
    before = [p.detach().clone() for p in tree_leaves(tp)]
    tp2, ts, tmet = tstep(tp, AdamW().init(tp), {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert ts.step == 1
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]), rtol=1e-7)
    leaves = tree_leaves(tp2)
    assert all(p.requires_grad for p in leaves)
    for g, w, b in zip(leaves, jax.tree_util.tree_leaves(jax.device_get(jp2)),
                       before):
        assert not torch.equal(g.detach(), b)  # every leaf moved
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=_step_tol(float(jmet["lr"])))


def test_checkpoint_resume_is_bit_identical(tmp_path):
    """4 steps straight == 2 steps, a crash in step 3, restore from the step-2
    checkpoint, 2 more steps: parameters, moments and metrics bitwise."""
    _, tcfg = _configs()
    _, tshape = _shapes(seq=32)
    tc = TrainConfig(steps=4, lr=1e-3, warmup=1, seed=0, ckpt_every=2,
                     log_every=100)
    seen = {}

    def record(run):
        def on_metrics(step, m):
            seen[(run, step)] = m["loss"], m["grad_norm"]
        return on_metrics

    p_a, s_a, _ = train(tcfg, tshape, tc, device="cpu", on_metrics=record("a"))

    class Crash(Exception):
        pass

    def crash(step, m):
        if step == 2:
            raise Crash
        record("b")(step, m)

    ckpt = dataclasses.replace(tc, ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(Crash):
        train(tcfg, tshape, ckpt, device="cpu", on_metrics=crash)
    p_b, s_b, _ = train(tcfg, tshape, ckpt, device="cpu",
                        on_metrics=record("b"))
    assert sorted(k for k in seen if k[0] == "b") == [("b", i) for i in range(4)]
    for i in range(4):
        assert seen[("a", i)] == seen[("b", i)]
    assert s_a.step == s_b.step == 4
    for got, want in ((p_b, p_a), (s_b.mu, s_a.mu), (s_b.nu, s_a.nu)):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w)


def test_unported_options_raise():
    _, tshape = _shapes()
    for arch in ("rwkv6-7b", "recurrentgemma-9b"):
        tcfg = get_smoke_config(arch, activ_dtype="float32")
        for tc in (TrainConfig(mesh_shape=(1, 1)),
                   TrainConfig(mesh_shape=(2, 2))):
            with pytest.raises(NotImplementedError,
                               match="ROADMAP module item 6b"):
                train(tcfg, tshape, tc, device="cpu")
