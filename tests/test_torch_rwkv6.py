"""Port parity: the rwkv6 family (repro_torch.models.rwkv6) vs the JAX package.

At the rwkv6-7b smoke config (2 layers, d_model 64, 4 heads of 16, chunk
8) with the reference's weights carried over by ``params_from_jax``, on
the CPU:

  * ``wkv_chunked`` against the reference's ``wkv_chunked`` and against the
    port's and the reference's token-by-token ``wkv_scan``, chunk 8 / 16 /
    32, with and without a carried ``initial_state`` (and the returned
    state): within 1e-4 of the output's largest magnitude, the reference
    test's criterion (tests/test_rwkv_rgemma.py). The port carries the
    inter-chunk state in a loop where the reference runs an associative
    scan: the same sums in another order;
  * ``forward`` logits and ``loss_fn`` within 1e-5 at fp32 activations,
    every parameter gradient within 1e-4 of the leaf's largest entry (as
    tests/test_torch_families.py), and the ``use_scan`` route against the
    chunked one;
  * the serving functions: the whole-prompt ``prefill`` and the ragged
    ``prefill_chunk`` then ``decode_step`` against the reference's (logits
    1e-5, states and carries 1e-5), and prefill then decode against
    stepwise decode at the reference test's tolerances;
  * the preset, the full config's parameter count (7.53 B), the stacked
    ``scan_layers`` layout through ``params_from_jax``, bitwise LM batches,
    and ``train()`` at the preset's remat="full".
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_params as jax_init
from repro.models import rwkv6 as JR
from repro.models.params import count_params
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.data import make_batch
from repro_torch.models import rwkv6 as TR
from repro_torch.models.params import (init_params, param_specs,
                                       params_from_jax, tree_leaves,
                                       tree_paths)
from repro_torch.models.registry import get_model
from repro_torch.train import TrainConfig, train

ARCH = "rwkv6-7b"


def _configs(**kw):
    kw.setdefault("activ_dtype", "float32")
    return jax_smoke(ARCH, **kw), get_smoke_config(ARCH, **kw)


def _weights(jcfg, tcfg, seed=0):
    jp = jax_init(JR.param_specs(jcfg), jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return jp, tp


def _np(t):
    return t.detach().float().numpy()


def _jit(fn, jcfg, **kw):
    """The reference's ``fn(params, jcfg, *args, **kw)`` under ``jax.jit``,
    the config and ``kw`` closed over (eager dispatch op by op took most
    of these tests' time)."""
    return jax.jit(lambda p, *args: fn(p, jcfg, *args, **kw))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-9))


def _wkv_inputs(seed, B=2, H=3, T=64, dh=8, chunk=16):
    r = np.random.default_rng(seed)
    rkv = [r.standard_normal((B, H, T, dh)).astype(np.float32) for _ in range(3)]
    lw = np.maximum(-np.exp(r.standard_normal((B, H, T, dh))),
                    -TR._decay_clamp(chunk)).astype(np.float32)
    u = r.standard_normal((H, dh)).astype(np.float32)
    s0 = r.standard_normal((B, H, dh, dh)).astype(np.float32)
    return (*rkv, lw, u), s0


# --------------------------------------------------------------------------- #
# the WKV recurrence
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_wkv_chunked_matches_reference_and_scan(chunk, carry):
    args, s0 = _wkv_inputs(chunk + 5 * carry, chunk=chunk)
    kw = dict(initial_state=s0, return_state=True) if carry else {}
    want = JR.wkv_chunked(*map(jnp.asarray, args), chunk,
                          **{k: jnp.asarray(v) if k == "initial_state" else v
                             for k, v in kw.items()})
    got = TR.wkv_chunked(*map(torch.from_numpy, args), chunk,
                         **{k: torch.from_numpy(v) if k == "initial_state"
                            else v for k, v in kw.items()})
    if carry:
        (want, want_s), (got, got_s) = want, got
        assert _rel(_np(got_s), want_s) < 1e-4
    assert got.shape == want.shape
    assert _rel(_np(got), want) < 1e-4
    if not carry:  # the recurrence, both packages
        scan = TR.wkv_scan(*map(torch.from_numpy, args))
        assert _rel(_np(got), _np(scan)) < 1e-4
        assert _rel(_np(scan), JR.wkv_scan(*map(jnp.asarray, args))) < 1e-5


def test_wkv_carried_state_composes():
    """Two windows with the state carried equal one window over both."""
    args, _ = _wkv_inputs(3, T=64, chunk=16)
    t = list(map(torch.from_numpy, args))
    y, s = TR.wkv_chunked(*t, 16, return_state=True)
    first = [a[:, :, :32] for a in t[:4]] + [t[4]]
    second = [a[:, :, 32:] for a in t[:4]] + [t[4]]
    y1, s1 = TR.wkv_chunked(*first, 16, return_state=True)
    y2, s2 = TR.wkv_chunked(*second, 16, initial_state=s1, return_state=True)
    assert _rel(_np(torch.cat([y1, y2], 2)), _np(y)) < 1e-5
    assert _rel(_np(s2), _np(s)) < 1e-5
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TR.wkv_chunked(*[a[:, :, :30] for a in t[:4]], t[4], 16)


# --------------------------------------------------------------------------- #
# training: forward, loss, gradients
# --------------------------------------------------------------------------- #
def _batch(jcfg, seq=32, batch=2, step=1, seed=3):
    shape = dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=seq,
                                global_batch=batch)
    return jax_make_batch(jcfg, shape, step=step, seed=seed)


def test_forward_loss_and_gradients_match_reference():
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, tcfg)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlogits, _ = _jit(JR.forward, jcfg)(jp, jb)
    tlogits, aux = TR.forward(tp, tcfg, tb)
    assert float(aux) == 0.0
    assert _rel(_np(tlogits), jlogits) < 1e-5

    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JR.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    tl, metrics = TR.loss_fn(tp, tcfg, tb)
    assert set(metrics) == {"loss", "nll"}
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    paths, leaves = zip(*tree_paths(tp))
    grads = torch.autograd.grad(tl, leaves)
    jgl = jax.tree.leaves(jg)
    assert len(jgl) == len(grads)
    for path, g, w in zip(paths, grads, jgl):
        assert _rel(_np(g), w) < 1e-4, "/".join(path)


def test_scan_route_matches_chunked_route():
    _, tcfg = _configs()
    tp = init_params(tcfg, seed=1, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(jax_smoke(ARCH)).items()}
    with torch.no_grad():
        a, _ = TR.forward(tp, tcfg, tb)
        b, _ = TR.forward(tp, tcfg, tb, use_scan=True)
    assert _rel(_np(a), _np(b)) < 1e-4


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_loss_and_gradients(remat):
    _, tcfg = _configs()
    tp = init_params(tcfg, seed=2, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in _batch(jax_smoke(ARCH)).items()}
    out = []
    for cfg in (tcfg, tcfg.replace(remat=remat)):
        loss, _ = TR.loss_fn(tp, cfg, tb)
        out.append((loss, torch.autograd.grad(loss, tree_leaves(tp))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


def test_train_runs_the_preset_remat(capsys):
    cfg = get_smoke_config(ARCH, activ_dtype="float32", remat="full")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=2)
    seen = []
    train(cfg, shape, TrainConfig(steps=2, log_every=1), device="cpu",
          on_metrics=lambda s, m: seen.append(m))
    assert len(seen) == 2 and all(np.isfinite(m["loss"]) for m in seen)
    assert abs(seen[0]["loss"] - np.log(cfg.vocab)) < 1.0
    assert capsys.readouterr().out.count(" tokens/s") == 2


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def _jcache(jcfg, B):
    return jax_init(JR.cache_specs(jcfg, B, 64), jax.random.PRNGKey(1))


def _tcache(tcfg, B):
    from repro_torch.models.params import materialize

    return {k: materialize(s, "cpu") for k, s in
            TR.cache_specs(tcfg, B, 64).items()}


def _cache_close(tc, jc, tol=1e-5):
    for key in ("state", "tm_x", "cm_x"):
        assert _rel(_np(tc[key]), jc[key]) < tol, key
    np.testing.assert_array_equal(tc["lengths"].numpy(), jc["lengths"])


def test_prefill_matches_reference():
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, tcfg)
    toks = np.random.default_rng(1).integers(1, tcfg.vocab, (2, 16)).astype(
        np.int32)
    jl, jc = _jit(JR.prefill, jcfg)(jp, {"tokens": jnp.asarray(toks)},
                                    _jcache(jcfg, 2))
    with torch.no_grad():
        tl, tc = TR.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            _tcache(tcfg, 2))
    assert _rel(_np(tl), jl) < 1e-5
    _cache_close(tc, jc)


def test_prefill_chunk_then_decode_match_reference():
    """Two ragged chunks (lengths 11 and 0, then 5 and 9; C = 12, padded to
    16 inside) and three decode steps with one slot frozen, against the
    reference's functions: logits and every cache leaf."""
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, tcfg)
    r = np.random.default_rng(4)
    jc, tc = _jcache(jcfg, 2), _tcache(tcfg, 2)
    jprefill = _jit(JR.prefill_chunk, jcfg)
    jdecode = jax.jit(lambda p, c, t, a: JR.decode_step(p, jcfg, c, t,
                                                        active=a))
    with torch.no_grad():
        for nv in ((11, 0), (5, 9)):
            toks = r.integers(1, tcfg.vocab, (2, 12)).astype(np.int32)
            nva = np.array(nv, np.int32)
            jl, jc = jprefill(jp, jc, jnp.asarray(toks), jnp.asarray(nva))
            tl, tc = TR.prefill_chunk(tp, tcfg, tc, torch.from_numpy(toks),
                                      torch.from_numpy(nva))
            live = nva > 0
            assert _rel(_np(tl)[live], np.asarray(jl)[live]) < 1e-5
            _cache_close(tc, jc)
        for act in ((True, True), (False, True), (True, False)):
            toks = r.integers(1, tcfg.vocab, (2,)).astype(np.int32)
            a = np.array(act)
            jl, jc = jdecode(jp, jc, jnp.asarray(toks), jnp.asarray(a))
            tl, tc = TR.decode_step(tp, tcfg, tc, torch.from_numpy(toks),
                                    active=torch.from_numpy(a))
            assert _rel(_np(tl)[a], np.asarray(jl)[a]) < 1e-5
            _cache_close(tc, jc)
        tl, _ = TR.prefill_chunk(tp, tcfg, tc, torch.ones((2, 4),
                                                          dtype=torch.int64),
                                 torch.tensor([4, 2]), all_logits=True)
    assert tl.shape == (2, 4, tcfg.padded_vocab)
    with pytest.raises(NotImplementedError, match="K/V"):
        TR.prefill_chunk(tp, tcfg, tc, torch.ones((2, 4), dtype=torch.int64),
                         torch.tensor([4, 2]), collect_kv=True)


def test_prefill_state_matches_decode_continuation():
    """decode after prefill == decode after stepwise feeding (the reference
    test's case and tolerances, tests/test_rwkv_rgemma.py), and the two
    prefill routes (whole prompt, chunked) agree."""
    _, cfg = _configs(activ_dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu")
    B, S = 2, cfg.rwkv_chunk * 2
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        lp, cp = TR.prefill(params, cfg, {"tokens": toks}, _tcache(cfg, B))
        cd = _tcache(cfg, B)
        for t in range(S):
            ld, cd = TR.decode_step(params, cfg, cd, toks[:, t])
        lc, cc = TR.prefill_chunk(params, cfg, _tcache(cfg, B), toks,
                                  torch.full((B,), S))
    np.testing.assert_allclose(_np(cp["state"]), _np(cd["state"]), atol=1e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(_np(lp), _np(ld), atol=0.05, rtol=0.05)
    np.testing.assert_allclose(_np(cc["state"]), _np(cp["state"]), atol=1e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(_np(lc), _np(lp), atol=0.05, rtol=0.05)


# --------------------------------------------------------------------------- #
# configs, parameters, batches
# --------------------------------------------------------------------------- #
def test_preset_equals_the_reference():
    for got, want in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        for f in dataclasses.fields(got):
            if f.name == "attention":
                assert got.attention.kind == want.attention.kind
            elif hasattr(want, f.name):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.family == "rwkv6" and get_model(got) is TR


def test_full_config_param_count():
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return math.prod(t.shape)

    n = count(param_specs(cfg))
    assert n == count_params(JR.param_specs(jcfg)) == 7_534_678_016


def test_params_from_jax_unstacks_scan_layers():
    jcfg, tcfg = _configs(scan_layers=True)
    jp = jax.device_get(jax_init(JR.param_specs(jcfg), jax.random.PRNGKey(5)))
    tp = params_from_jax(jp, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers
    np.testing.assert_array_equal(tp["layers"][1]["tm"]["wk"].numpy(),
                                  np.asarray(jp["layers"]["tm"]["wk"])[1])


@pytest.mark.parametrize("seq,batch,step,seed", [(32, 2, 0, 0), (48, 3, 5, 7)])
def test_make_batch_bitwise(seq, batch, step, seed):
    jcfg, tcfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jshape = dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=seq,
                                 global_batch=batch)
    tshape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq,
                                 global_batch=batch)
    want = jax_make_batch(jcfg, jshape, step=step, seed=seed)
    got = make_batch(tcfg, tshape, step=step, seed=seed)
    assert set(got) == set(want) == {"tokens", "targets"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])
