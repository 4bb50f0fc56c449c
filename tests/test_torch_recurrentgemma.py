"""Port parity: the recurrentgemma family (repro_torch.models.recurrentgemma)
vs the JAX package.

At the recurrentgemma-9b smoke config (3 layers in the (rglru, rglru,
local) pattern, d_model 64, 4 query heads over one KV head of 16, window 32)
with the reference's weights carried over by ``params_from_jax``, on the
CPU:

  * the RG-LRU pieces: the doubling scan against a sequential loop (the
    reference test's 1e-4) and against the reference's associative scan,
    its cumulative decay, ``_decay`` near one, the causal conv with and
    without a carried state;
  * the ``local`` attention kind: ``_local_attention`` (causal and not,
    with a key mask, a length that is no multiple of the window),
    ``_local_decode_attention`` and ``chunk_attention``'s window against
    the reference's;
  * ``forward`` logits and ``loss_fn`` within 1e-5 at fp32 activations and
    every parameter gradient within 1e-4 of the leaf's largest entry, for
    the ``local`` preset and for the MRA-2 variant on the smoke presets'
    MRA-2 parameters (b = 16, two blocks a row), the latter against the
    reference's jnp route and its Pallas kernels in interpret mode (the
    port's wrapper takes the plain twins on the CPU);
  * the serving functions: the whole-prompt ``prefill`` (``local`` and
    MRA-2), the ragged ``prefill_chunk`` past the window then
    ``decode_step`` with frozen slots, against the reference's (logits and
    every cache leaf 1e-5), and prefill then decode against stepwise
    decode at the reference test's tolerances;
  * the preset value for value, the full config's parameter count
    (8,533,004,288), the reference's ``groups`` / ``tail`` layout through
    ``params_from_jax`` at 38 layers (12 groups of 3 and a tail of 2),
    bitwise LM batches, and ``train()`` at the preset's remat="full".
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
from repro.core import attention as JA
from repro.core.attention import AttentionSpec as JSpec
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import init_params as jax_init
from repro.models import recurrentgemma as JR
from repro.models.params import count_params
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.core import attention as TA
from repro_torch.core.attention import AttentionSpec as TSpec
from repro_torch.data import make_batch
from repro_torch.models import recurrentgemma as TR
from repro_torch.models.params import (init_params, materialize, param_specs,
                                       params_from_jax, tree_leaves,
                                       tree_paths)
from repro_torch.models.registry import get_model
from repro_torch.train import TrainConfig, train

ARCH = "recurrentgemma-9b"
# the MRA-2 parameters of the smoke presets (b = 16, two blocks a row)
MRA = dict(kind="mra2", block_size=16, blocks_per_row=2)


def _configs(mra=False, **kw):
    kw.setdefault("activ_dtype", "float32")
    if mra:
        return (jax_smoke(ARCH, attention=JSpec(**MRA), **kw),
                get_smoke_config(ARCH, attention=TSpec(**MRA), **kw))
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


# --------------------------------------------------------------------------- #
# the RG-LRU pieces
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("T", [1, 7, 32, 128])
def test_rglru_scan_matches_loop_and_reference(T):
    r = np.random.default_rng(T)
    B, W = 2, 8
    a = (r.random((B, T, W)) * 0.9 + 0.05).astype(np.float32)
    bx = r.standard_normal((B, T, W)).astype(np.float32)
    acum, h = TR._rglru_scan(torch.from_numpy(a), torch.from_numpy(bx))
    href, cref = np.zeros((B, W), np.float32), np.ones((B, W), np.float32)
    out, cum = np.zeros((B, T, W), np.float32), np.zeros((B, T, W), np.float32)
    for t in range(T):
        href = a[:, t] * href + bx[:, t]
        cref = cref * a[:, t]
        out[:, t], cum[:, t] = href, cref
    np.testing.assert_allclose(_np(h), out, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(acum), cum, atol=1e-6, rtol=1e-5)
    ja, jh = JR._rglru_scan(jnp.asarray(a), jnp.asarray(bx))
    np.testing.assert_allclose(_np(h), np.asarray(jh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(acum), np.asarray(ja), atol=1e-6, rtol=1e-5)


def test_rglru_decay_stable_near_one():
    lam, gate = torch.tensor([-10.0, 0.0, 10.0]), torch.ones(3)
    a, mult = TR._decay(lam, gate)
    assert bool(((a > 0) & (a < 1)).all()) and bool(torch.isfinite(mult).all())
    ja, jm = JR._decay(jnp.asarray(lam.numpy()), jnp.asarray(gate.numpy()))
    np.testing.assert_allclose(_np(a), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(_np(mult), np.asarray(jm), rtol=1e-6)
    # near a = 1 the expm1 form keeps sqrt(1 - a^2) off zero
    _, small = TR._decay(torch.tensor([-30.0]), torch.tensor([1e-3]))
    assert float(small) > 0.0


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_reference(carry):
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 9, 6)).astype(np.float32)
    w = r.standard_normal((4, 6)).astype(np.float32)
    b = r.standard_normal((6,)).astype(np.float32)
    st = r.standard_normal((2, 3, 6)).astype(np.float32) if carry else None
    got = TR._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b),
                          None if st is None else torch.from_numpy(st))
    want = JR._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6)


# --------------------------------------------------------------------------- #
# the local attention kind
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("N,w,masked", [(64, 16, False), (50, 16, True),
                                        (12, 32, False), (40, 8, True)])
def test_local_attention_matches_reference(N, w, masked, causal):
    r = np.random.default_rng(N + w)
    q = r.standard_normal((2, 4, N, 16)).astype(np.float32)
    k = r.standard_normal((2, 2, N, 16)).astype(np.float32)
    v = r.standard_normal((2, 2, N, 16)).astype(np.float32)
    km = r.random((2, N)) > 0.2 if masked else None
    want = JA.self_attention(
        *map(jnp.asarray, (q, k, v)), JSpec(kind="local", local_window=w),
        causal=causal, key_mask=None if km is None else jnp.asarray(km))
    got = TA.self_attention(
        *map(torch.from_numpy, (q, k, v)), TSpec(kind="local", local_window=w),
        causal=causal, key_mask=None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_local_decode_and_chunk_attention_match_reference():
    r = np.random.default_rng(7)
    B, Hq, Hkv, S, D, C, w = 3, 4, 1, 48, 16, 5, 12
    k = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
    lengths = np.array([48, 20, 3], np.int32)
    js, ts = JSpec(kind="local", local_window=w), TSpec(kind="local",
                                                        local_window=w)
    q1 = r.standard_normal((B, Hq, 1, D)).astype(np.float32)
    want = JA.decode_attention(*map(jnp.asarray, (q1, k, v, lengths)), js)
    got = TA.decode_attention(*map(torch.from_numpy, (q1, k, v, lengths)), ts)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    qc = r.standard_normal((B, Hq, C, D)).astype(np.float32)
    q_pos = (lengths[:, None] - C + np.arange(C)[None]).astype(np.int32)
    want = JA.chunk_attention(*map(jnp.asarray, (qc, k, v, lengths, q_pos)), js)
    got = TA.chunk_attention(*map(torch.from_numpy, (qc, k, v, lengths, q_pos)),
                             ts)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------------------- #
# training: forward, loss, gradients
# --------------------------------------------------------------------------- #
def _batch(jcfg, seq=48, batch=2, step=1, seed=3):
    shape = dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=seq,
                                global_batch=batch)
    return jax_make_batch(jcfg, shape, step=step, seed=seed)


ROUTES = {"local": dict(mra=False),
          "mra2-jnp": dict(mra=True),
          "mra2-pallas": dict(mra=True, kernel=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_forward_loss_and_gradients_match_reference(route):
    """Logits (1e-5), loss (1e-5) and every gradient (1e-4 of the leaf's
    largest entry) against the reference; the MRA-2 variant's local layers
    against the reference's jnp route and its Pallas kernels (interpret
    mode) at seq 48 (padded to 64 inside: four 16-wide blocks)."""
    opt = ROUTES[route]
    jcfg, tcfg = _configs(mra=opt["mra"])
    if opt.get("kernel"):
        jcfg = jcfg.replace(attn_use_kernel=True, attn_interpret=True)
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


def test_mra2_local_layers_take_the_block_sparse_route():
    """Under MRA-2 the local layers run ``mra2_attention`` (the block-sparse
    autograd function: its plain twins here), under ``local`` they do not."""
    from unittest import mock

    from repro_torch.kernels import block_sparse_attn as bsa

    for mra, want in ((True, 1), (False, 0)):
        _, tcfg = _configs(mra=mra)
        tp = init_params(tcfg, seed=0, device="cpu")
        tb = {k: torch.from_numpy(v) for k, v in _batch(jax_smoke(ARCH)).items()}
        with mock.patch.object(bsa, "_forward", wraps=bsa._forward) as fwd, \
                torch.no_grad():
            TR.forward(tp, tcfg, tb)
        assert fwd.call_count == want  # one local layer in the smoke pattern


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


@pytest.mark.parametrize("mra", [False, True], ids=["local", "mra2"])
def test_train_runs_the_preset_remat(capsys, mra):
    _, cfg = _configs(mra=mra, remat="full")
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
def _jcache(jcfg, B, max_len=64):
    return jax_init(JR.cache_specs(jcfg, B, max_len), jax.random.PRNGKey(1))


def _tcache(tcfg, B, max_len=64):
    return {k: materialize(s, "cpu") for k, s in
            TR.cache_specs(tcfg, B, max_len).items()}


def _cache_close(tc, jc, tol=1e-5):
    assert set(tc) == set(jc)
    for key in ("k", "v", "h", "conv"):
        assert _rel(_np(tc[key]), jc[key]) < tol, key
    for key in ("kv_pos", "lengths"):
        np.testing.assert_array_equal(tc[key].numpy(), jc[key])


@pytest.mark.parametrize("mra,S", [(False, 16), (False, 45), (True, 48)],
                         ids=["local-16", "local-45-wraps", "mra2-48-wraps"])
def test_prefill_matches_reference(mra, S):
    jcfg, tcfg = _configs(mra=mra)
    jp, tp = _weights(jcfg, tcfg)
    toks = np.random.default_rng(1).integers(1, tcfg.vocab, (2, S)).astype(
        np.int32)
    jl, jc = _jit(JR.prefill, jcfg)(jp, {"tokens": jnp.asarray(toks)},
                                    _jcache(jcfg, 2))
    with torch.no_grad():
        tl, tc = TR.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            _tcache(tcfg, 2))
    assert _rel(_np(tl), jl) < 1e-5
    _cache_close(tc, jc)


def test_prefill_chunk_then_decode_match_reference():
    """Ragged chunks (lengths (20, 0), (32, 9), (7, 32): the first slot's
    ring wraps its 32 entries) and decode steps with one slot frozen, then
    every position valid: logits and every cache leaf against the
    reference's."""
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, tcfg)
    r = np.random.default_rng(4)
    jc, tc = _jcache(jcfg, 2), _tcache(tcfg, 2)
    jprefill = _jit(JR.prefill_chunk, jcfg)
    jdecode = jax.jit(lambda p, c, t, a: JR.decode_step(p, jcfg, c, t,
                                                        active=a))
    with torch.no_grad():
        for nv in ((20, 0), (32, 9), (7, 32)):
            toks = r.integers(1, tcfg.vocab, (2, 32)).astype(np.int32)
            nva = np.array(nv, np.int32)
            jl, jc = jprefill(jp, jc, jnp.asarray(toks), jnp.asarray(nva))
            tl, tc = TR.prefill_chunk(tp, tcfg, tc, torch.from_numpy(toks),
                                      torch.from_numpy(nva))
            live = nva > 0
            assert _rel(_np(tl)[live], np.asarray(jl)[live]) < 1e-5
            _cache_close(tc, jc)
        for act in ((True, True), (False, True), (True, False), (True, True)):
            toks = r.integers(1, tcfg.vocab, (2,)).astype(np.int32)
            a = np.array(act)
            jl, jc = jdecode(jp, jc, jnp.asarray(toks), jnp.asarray(a))
            tl, tc = TR.decode_step(tp, tcfg, tc, torch.from_numpy(toks),
                                    active=torch.from_numpy(a))
            assert _rel(_np(tl)[a], np.asarray(jl)[a]) < 1e-5
            _cache_close(tc, jc)
        toks = r.integers(1, tcfg.vocab, (2, 4)).astype(np.int32)
        jl, _ = _jit(JR.prefill_chunk, jcfg, all_logits=True)(
            jp, jc, jnp.asarray(toks), jnp.asarray(np.array([4, 2], np.int32)))
        tl, _ = TR.prefill_chunk(tp, tcfg, tc, torch.from_numpy(toks),
                                 torch.tensor([4, 2]), all_logits=True)
    assert tl.shape == (2, 4, tcfg.padded_vocab)
    assert _rel(_np(tl)[0], np.asarray(jl)[0]) < 1e-5
    with pytest.raises(NotImplementedError, match="K/V"):
        TR.prefill_chunk(tp, tcfg, tc, torch.ones((2, 4), dtype=torch.int64),
                         torch.tensor([4, 2]), collect_kv=True)


def test_ring_buffer_decode_matches_prefill():
    """decode after stepwise feeding == whole-prompt prefill (the reference
    test's case and tolerances, tests/test_rwkv_rgemma.py), and the chunked
    route agrees."""
    _, cfg = _configs(activ_dtype="bfloat16")
    params = init_params(cfg, seed=0, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        lp, _ = TR.prefill(params, cfg, {"tokens": toks}, _tcache(cfg, B))
        cd = _tcache(cfg, B)
        for t in range(S):
            ld, cd = TR.decode_step(params, cfg, cd, toks[:, t])
        lc, _ = TR.prefill_chunk(params, cfg, _tcache(cfg, B), toks,
                                 torch.full((B,), S))
    np.testing.assert_allclose(_np(lp), _np(ld), atol=0.05, rtol=0.05)
    np.testing.assert_allclose(_np(lc), _np(lp), atol=0.05, rtol=0.05)


# --------------------------------------------------------------------------- #
# configs, parameters, batches
# --------------------------------------------------------------------------- #
def test_preset_equals_the_reference():
    for got, want in ((get_config(ARCH), jax_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        for f in dataclasses.fields(got):
            if f.name == "attention":
                for g in dataclasses.fields(got.attention):
                    if hasattr(want.attention, g.name):
                        assert getattr(got.attention, g.name) == getattr(
                            want.attention, g.name), g.name
            elif hasattr(want, f.name):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.family == "recurrentgemma" and get_model(got) is TR
    assert TSpec().local_window == JSpec().local_window == 1024


def _count(t):
    if isinstance(t, dict):
        return sum(_count(v) for v in t.values())
    if isinstance(t, list):
        return sum(_count(v) for v in t)
    return math.prod(t.shape)


def test_full_config_param_count():
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    n = _count(param_specs(cfg))
    assert n == count_params(JR.param_specs(jcfg)) == 8_533_004_288


def test_params_from_jax_unstacks_groups_and_tail():
    """The reference's scan layout at 38 layers: ``groups`` holds one
    (12, ...) tree per pattern position and ``tail`` the last 2 layers;
    the port's layer list follows ``_layers_iter``'s order, each layer its
    own leaves (checked on every leaf, so a swapped group or position
    shows)."""
    jcfg, tcfg = _configs(scan_layers=True, num_layers=38)
    jp = jax.device_get(jax_init(JR.param_specs(jcfg), jax.random.PRNGKey(5)))
    assert len(jp["tail"]) == 2 and len(jp["groups"]) == 3
    tp = params_from_jax(jp, tcfg, device="cpu")
    assert len(tp["layers"]) == 38
    want = [p for _, p in JR._layers_iter(jp, jcfg)]
    for i, (kind, layer) in enumerate(TR._layers_iter(tp, tcfg)):
        assert kind == ("local" if i % 3 == 2 else "rglru")
        for (path, got), w in zip(tree_paths(layer),
                                  jax.tree.leaves(want[i])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w),
                                          err_msg=f"layer {i} {path}")
    with pytest.raises(ValueError, match="scan_layers=False"):
        params_from_jax(jp, tcfg.replace(scan_layers=False), device="cpu")


def test_init_params_draws_the_declared_scales():
    """``lam`` is an ``embed`` init at std 0.5 (the reference's ParamSpec
    scale), ``wa`` / ``wi`` normal at 0.01, the conv at 0.1, biases 0, and
    the serving cache's ``kv_pos`` starts at -1."""
    cfg = get_smoke_config(ARCH, lru_width=512, d_model=512)
    p = init_params(cfg, seed=0, device="cpu")["layers"][0]["rglru"]
    assert 0.4 < float(p["lam"].std()) < 0.6
    assert 0.007 < float(p["wa"].std()) < 0.011
    assert 0.07 < float(p["conv_w"].std()) < 0.11
    assert float(p["ba"].abs().max()) == 0.0 == float(p["conv_b"].abs().max())
    c = _tcache(cfg, 2)
    assert int(c["kv_pos"].max()) == -1 and c["kv_pos"].dtype == torch.int32


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
        np.testing.assert_array_equal(got[k], want[k])
