"""Port parity: the one-device training loop's machinery vs the reference.

On the CPU, at the smoke configs:

  * ``make_batch`` for the MoE family bit-identical to the reference's (and
    its shard / batch_override arguments); the hubert and internvl frontends
    raise naming ROADMAP;
  * the prefetching ``DataLoader`` yields ``make_batch``'s ``(step, batch)``
    stream, hands a worker's error to the caller, and ``close()`` leaves no
    live thread; ``train()`` closes its loader;
  * ``compress`` bitwise equal to the reference's on random fp32 arrays
    with a residual, ``decompress`` and ``init_ef`` alike; one
    ``make_train_step`` step with ``microbatches=2`` and
    ``grad_compression="bf16_ef"`` against the reference's with the same
    settings (loss and grad norm within 1e-5, parameters within
    ``_step_tol``);
  * ``AsyncCheckpointer``: a round trip with its ``extra`` metadata, and a
    tree updated in place right after ``save`` returns still writes the
    values it had at the call;
  * SIGTERM from inside step 1 leaves a checkpoint at step 2 and returns;
    resuming from it gives parameters bitwise equal to an uninterrupted
    run's; the old handler is back afterwards;
  * the straggler flag fires on a step made slow through a patched clock,
    and not before step 4.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import make_batch as jax_make_batch
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jax_cosine
from repro.optim.compression import EFState as JEFState
from repro.optim.compression import compress as jax_compress
from repro.optim.compression import decompress as jax_decompress
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataLoader, make_batch
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamW, EFState, compress, cosine_schedule
from repro_torch.optim import decompress, init_ef
from repro_torch.train import TrainConfig, make_train_step, train
from repro_torch.train import loop as loop_mod
from test_torch_train import _configs, _kernel_route, _shapes, _step_tol
from test_torch_train import _weights

MOE = "granite-moe-3b-a800m"


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq,batch,step,seed", [(64, 2, 0, 0), (33, 3, 5, 7)])
def test_make_batch_moe_bit_identical(seq, batch, step, seed):
    jcfg, tcfg = jax_smoke(MOE), get_smoke_config(MOE)
    jshape, tshape = _shapes(seq, batch)
    for kw in ({}, dict(shard=1, num_shards=2, batch_override=2)):
        want = jax_make_batch(jcfg, jshape, step=step, seed=seed, **kw)
        got = make_batch(tcfg, tshape, step=step, seed=seed, **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-1b"])
def test_make_batch_frontends_bit_identical(arch):
    """hubert's frames, mask and targets and internvl's tokens and patches
    (the reference's rng order)."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jshape, tshape = _shapes(40, 3)
    want = jax_make_batch(jcfg, jshape, step=2, seed=4)
    got = make_batch(tcfg, tshape, step=2, seed=4)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


def test_make_batch_refuses_the_recurrent_families():
    """rwkv6 and recurrentgemma take LM batches, the dense family's
    (tests/test_torch_rwkv6.py and tests/test_torch_recurrentgemma.py hold
    them to the reference's); a family the port does not know raises."""
    _, tshape = _shapes()
    dense = get_smoke_config("qwen3-1.7b")
    want = make_batch(dense, tshape, step=1, seed=2)
    for family in ("rwkv6", "recurrentgemma"):
        got = make_batch(dense.replace(family=family), tshape, step=1, seed=2)
        assert set(got) == set(want) == {"tokens", "targets"}
        assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="unknown model family 'mamba'"):
        make_batch(dense.replace(family="mamba"), tshape)


def test_loader_streams_make_batch_and_closes():
    cfg = get_smoke_config(MOE)
    _, shape = _shapes(48, 4)
    kw = dict(shard=1, num_shards=2, batch_override=3)
    loader = DataLoader(cfg, shape, seed=3, start_step=5, prefetch=2, **kw)
    try:
        got = [next(loader) for _ in range(4)]
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for step, batch in got:
        want = make_batch(cfg, shape, step=step, seed=3, **kw)
        assert all(np.array_equal(batch[k], want[k]) for k in want)


def test_loader_hands_on_the_workers_error():
    cfg = get_smoke_config("qwen3-1.7b").replace(family="mamba")
    _, shape = _shapes()
    loader = DataLoader(cfg, shape)
    try:
        with pytest.raises(ValueError, match="mamba"):
            next(loader)
    finally:
        loader.close()
    assert not loader._thread.is_alive()


def test_train_closes_its_loader():
    _, tcfg = _configs()
    _, tshape = _shapes(seq=32)
    before = threading.active_count()
    train(tcfg, tshape, TrainConfig(steps=1, log_every=100), device="cpu")
    assert threading.active_count() == before


# --------------------------------------------------------------------------- #
# bf16 error feedback
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(3))
def test_compress_is_bitwise_the_reference(seed):
    r = np.random.default_rng(seed)
    shapes = {"a": (7, 33), "b": [(5,), (2, 3, 129)]}
    grads = {"a": r.standard_normal(shapes["a"]).astype(np.float32) * 10.0,
             "b": [r.standard_normal(s).astype(np.float32) * 1e-3
                   for s in shapes["b"]]}
    res = {"a": r.standard_normal(shapes["a"]).astype(np.float32) * 1e-2,
           "b": [r.standard_normal(s).astype(np.float32) * 1e-5
                 for s in shapes["b"]]}
    jq, jef = jax_compress(grads, JEFState(res))

    def tt(tree):
        return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)

    tq, tef = compress(tt(grads), EFState(tt(res)))
    assert isinstance(tef, EFState)
    for got, want in zip(tree_leaves(tq), jax.tree_util.tree_leaves(jq)):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16))
    for got, want in zip(tree_leaves(tef.residual),
                         jax.tree_util.tree_leaves(jef.residual)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tree_leaves(decompress(tq)),
                         jax.tree_util.tree_leaves(jax_decompress(jq))):
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want))
    zeros = init_ef(tt(grads))
    assert all(float(z.abs().max()) == 0.0 and z.dtype == torch.float32
               for z in tree_leaves(zeros.residual))


def test_bf16_ef_train_step_matches_reference():
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, tcfg)
    jshape, _ = _shapes(batch=4)
    batch = jax_make_batch(jcfg, jshape, step=0, seed=0)
    lr = 1e-3
    kw = dict(steps=10, microbatches=2, grad_compression="bf16_ef")
    jstep = jax_make_train_step(jcfg, JTrainConfig(**kw), JAdamW(),
                                jax_cosine(lr, 2, 10))
    with _kernel_route():
        jp2, _, jmet = jax.jit(jstep)(jp, JAdamW().init(jp), {
            k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tcfg, TrainConfig(**kw), AdamW(),
                            cosine_schedule(lr, 2, 10))
    tp2, _, tmet = tstep(tp, AdamW().init(tp), {
        k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5)
    for g, w in zip(tree_leaves(tp2),
                    jax.tree_util.tree_leaves(jax.device_get(jp2))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0,
                                   atol=_step_tol(float(jmet["lr"])))


def test_unknown_grad_compression_raises():
    with pytest.raises(ValueError, match="grad_compression"):
        make_train_step(_configs()[1], TrainConfig(grad_compression="int8"),
                        AdamW(), cosine_schedule(1e-3, 1, 2))


# --------------------------------------------------------------------------- #
# checkpoints, preemption, stragglers
# --------------------------------------------------------------------------- #
def _tree():
    r = np.random.default_rng(0)
    return {"w": torch.from_numpy(r.standard_normal((4, 5)).astype(np.float32)),
            "h": [torch.from_numpy(r.standard_normal(3).astype(np.float32))
                  .to(torch.bfloat16)], "step": 7}


def test_async_checkpointer_round_trip(tmp_path):
    tree = _tree()
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path), 3, tree, extra={"note": "x"})
    ck.wait()
    assert ck.last_path == str(tmp_path / "step_3")
    assert latest_step(str(tmp_path)) == 3
    with open(tmp_path / "step_3" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"note": "x"}
    back = restore(str(tmp_path), 3, tree)
    assert back["step"] == 7
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["h"][0], tree["h"][0])


def test_async_checkpointer_snapshots_before_returning(tmp_path):
    """AdamW updates in place, and a CPU tensor's .cpu() is itself: the
    values written are those at the call, not those after it."""
    tree = _tree()
    want = {"w": tree["w"].clone(), "h": tree["h"][0].clone()}
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path), 1, tree)
    tree["w"].add_(1.0)
    tree["h"][0].mul_(3.0)
    ck.wait()
    back = restore(str(tmp_path), 1, tree)
    assert torch.equal(back["w"], want["w"])
    assert torch.equal(back["h"][0], want["h"])


def test_sigterm_checkpoints_and_resumes_bitwise(tmp_path):
    _, tcfg = _configs()
    _, tshape = _shapes(seq=32)
    tc = TrainConfig(steps=4, lr=1e-3, warmup=1, seed=0, ckpt_every=100,
                     log_every=100, ckpt_dir=str(tmp_path / "ck"))
    straight, _, _ = train(tcfg, tshape, dataclasses.replace(tc, ckpt_dir=None),
                           device="cpu")
    seen = []

    def term_at_1(step, m):
        seen.append(step)
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    train(tcfg, tshape, tc, device="cpu", on_metrics=term_at_1)
    assert seen == [0, 1]
    assert signal.getsignal(signal.SIGTERM) is handler
    assert latest_step(tc.ckpt_dir) == 2
    assert latest_step(tc.ckpt_dir + "/opt") == 2
    resumed, state, _ = train(tcfg, tshape, tc, device="cpu",
                              on_metrics=lambda s, m: seen.append(s))
    assert seen == [0, 1, 2, 3] and state.step == 4
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert torch.equal(a, b)


class _Clock:
    """perf_counter of a patched ``time``: every step takes 1 s, step
    ``slow`` 10 s (the loop reads it at a step's start and end)."""

    def __init__(self, slow):
        self.slow, self.calls, self.now = slow, 0, 0.0

    def perf_counter(self):
        if self.calls % 2:
            self.now += 10.0 if self.calls // 2 == self.slow else 1.0
        self.calls += 1
        return self.now


@pytest.mark.parametrize("slow,flagged", [(2, False), (3, False), (5, True)])
def test_straggler_flag(capsys, slow, flagged):
    _, tcfg = _configs()
    _, tshape = _shapes(seq=32)
    with mock.patch.object(loop_mod, "time", _Clock(slow)):
        train(tcfg, tshape, TrainConfig(steps=7, log_every=100), device="cpu")
    out = capsys.readouterr().out
    assert (f"[straggler] step {slow} took 10.000s" in out) == flagged
    assert out.count("[straggler]") == int(flagged)
