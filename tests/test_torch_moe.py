"""Port parity: repro_torch.models.moe and the MoE family vs the reference.

The same numpy inputs (or the reference's weights, carried over by
``params_from_jax``) go through ``repro.models.moe`` / ``transformer`` and
their ports on the CPU, in fp32:

  * ``_route``: expert indices exactly (also on tied router probabilities,
    where both keep the lowest expert index first), gates and the two aux
    losses within 1e-6;
  * ``_dispatch`` / ``_combine`` with the capacity large (nothing dropped)
    and small (drops): the kept mask and the scatter coordinates exactly,
    expert buffers and combined outputs within 1e-5;
  * ``moe_block`` on the kimi-k2 and granite-moe smoke configs within 1e-5;
  * full-model ``forward`` / ``loss_fn``: logits within 1e-4, aux and loss
    within 1e-6 (relative);
  * granite-moe's ``prefill_chunk`` / ``decode_step`` over ragged chunks and
    decode waves with frozen slots (whose padded rows route and take
    capacity) past the ring: logits within 1e-4, caches within 1e-5
    normwise, page tables and lengths exactly (``test_torch_transformer``'s
    rules), frozen slots bit-identical;
  * greedy engine streams of the granite smoke through the registry, plain
    and speculative (``spec_k=3``), exactly the JAX engine's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro_torch.configs import MoESpec, get_smoke_config
from repro_torch.models import moe as TM
from repro_torch.models import registry
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_jax
from repro_torch.serve import Engine, EngineConfig, Request
from repro_torch.serve.cache import RingPagedKVCache
from test_torch_transformer import (
    B,
    MAX_LEN,
    _assert_rows_equal,
    _cache_close,
    _frozen_rows,
    _jax_fns,
    _schedule,
)

MOE_ARCHS = ["granite-moe-3b-a800m", "kimi-k2-1t-a32b"]


def _spec(E=5, k=2, cf=1.25):
    from repro.configs.base import MoESpec as JMoESpec

    kw = dict(num_experts=E, top_k=k, d_ff_expert=8, capacity_factor=cf)
    return JMoESpec(**kw), MoESpec(**kw)


def _f32(r, *shape):
    return r.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------- #
# routing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,E,k", [(0, 5, 2), (1, 8, 2), (2, 40, 8),
                                      (3, 16, 1)])
def test_route_matches_jax(seed, E, k):
    r = np.random.default_rng(seed)
    x, wr = _f32(r, 64, 24), _f32(r, 24, E)
    js, ts = _spec(E, k)
    jg, ji, ja = JM._route(jnp.asarray(x), jnp.asarray(wr), js)
    tg, ti, ta = TM._route(torch.from_numpy(x), torch.from_numpy(wr), ts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    assert set(ta) == set(ja)
    for key in ja:
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), rtol=1e-6,
                                   err_msg=key)


def test_route_ties_keep_the_lowest_expert_first():
    """Experts 1, 3 and 4 share a router column, so their probabilities are
    equal for every token: both packages pick them lowest index first. A
    constant input feature favours the three by 3 logits (not so far that
    the others' probabilities turn denormal, which XLA's CPU flushes)."""
    r = np.random.default_rng(7)
    x, wr = _f32(r, 32, 16), _f32(r, 16, 6)
    x[:, 0] = 1.0
    wr[0, 1] = 3.0
    wr[:, 3] = wr[:, 4] = wr[:, 1]
    js, ts = _spec(6, 3)
    _, ji, _ = JM._route(jnp.asarray(x), jnp.asarray(wr), js)
    _, ti, _ = TM._route(torch.from_numpy(x), torch.from_numpy(wr), ts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tied = (ti == 1).any(-1) & (ti == 3).any(-1) & (ti == 4).any(-1)
    assert bool(tied.any())
    rows = ti[tied].numpy()
    assert (rows == np.array([1, 3, 4])).all()


# --------------------------------------------------------------------------- #
# dispatch and combine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cap,drops", [(64, False), (3, True)])
@pytest.mark.parametrize("e0,e_local", [(0, 5), (1, 3)])
def test_dispatch_and_combine_match_jax(cap, drops, e0, e_local):
    r = np.random.default_rng(11)
    T, k, E, d = 24, 2, 5, 12
    x = _f32(r, T, d)
    idx = np.stack([r.permutation(E)[:k] for _ in range(T)]).astype(np.int32)
    gates = np.abs(_f32(r, T, k))
    jbuf, jmeta = JM._dispatch(jnp.asarray(x), jnp.asarray(idx), e0=e0,
                               e_local=e_local, capacity=cap)
    tbuf, tmeta = TM._dispatch(torch.from_numpy(x),
                               torch.from_numpy(idx).long(), e0=e0,
                               e_local=e_local, capacity=cap)
    for name, t, j in zip(("order", "e_scatter", "s_scatter", "keep", "tok"),
                          tmeta, jmeta):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    keep = tmeta[3].numpy()
    assert (not keep.all()) == (drops or e_local < E)
    np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), atol=1e-5)
    y = _f32(r, e_local, cap, d)
    jout = JM._combine(jnp.asarray(y), jmeta, jnp.asarray(gates), T)
    tout = TM._combine(torch.from_numpy(y), tmeta, torch.from_numpy(gates), T)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)


@pytest.mark.parametrize("T", [1, 4, 7, 96, 512, 4096])
def test_capacity_formula(T):
    for js, ts in (_spec(40, 8), _spec(5, 2, 2.0), _spec(384, 8)):
        want = max(int(T * js.top_k * js.capacity_factor / js.num_experts
                       + 1), 4)
        assert TM.capacity(T, ts) == want


# --------------------------------------------------------------------------- #
# the block and the model
# --------------------------------------------------------------------------- #
def _setup(arch, seed=0):
    jcfg = jax_smoke(arch, activ_dtype="float32")
    tcfg = get_smoke_config(arch, activ_dtype="float32")
    jp = jax_init(jax_get_model(jcfg).param_specs(jcfg),
                  jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), tcfg,
                                           device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    x = _f32(np.random.default_rng(5), 3, 20, tcfg.d_model)
    jo, ja = JM.moe_block(jnp.asarray(x), jp["layers"][0]["moe"], jcfg)
    to, ta = TM.moe_block(torch.from_numpy(x), tp["layers"][0]["moe"], tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    for key in ja:
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_loss_match_jax(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    r = np.random.default_rng(6)
    toks = r.integers(0, jcfg.vocab, (2, 64))
    tgts = r.integers(0, jcfg.vocab, (2, 64))
    jl, jaux = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, taux = TT.forward(tp, tcfg, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0
    batch = {"tokens": toks, "targets": tgts}
    jloss, jm = JT.loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                      batch.items()})
    tloss, tm = TT.loss_fn(tp, tcfg, {k: torch.as_tensor(v) for k, v in
                                      batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               rtol=1e-6)


def test_moe_dispatch_other_than_psum_raises():
    """A dispatch that is neither "psum" nor "a2a" raises; without a mesh
    "a2a" is the local path (the mesh dispatches:
    tests/test_torch_dist_train.py)."""
    _, tcfg, _, tp = _setup("granite-moe-3b-a800m")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, tcfg.d_model)).astype(np.float32))
    p = tp["layers"][0]["moe"]
    with pytest.raises(ValueError, match="moe_dispatch"):
        TM.moe_block(x, p, tcfg.replace(moe_dispatch="gather"))
    want, _ = TM.moe_block(x, p, tcfg)
    got, _ = TM.moe_block(x, p, tcfg.replace(moe_dispatch="a2a"))
    assert torch.equal(got, want)


def test_router_init_scale():
    """The router is drawn at std 0.02, an expert at fan-in std."""
    from repro_torch.models.params import init_params

    cfg = get_smoke_config("granite-moe-3b-a800m").replace(d_model=256)
    p = init_params(cfg, seed=0, device="cpu")["layers"][0]["moe"]
    assert float(p["router"].std()) == pytest.approx(0.02 * 0.88, rel=0.1)
    assert float(p["router"].abs().max()) <= 0.04 + 1e-6
    assert float(p["wi"].abs().max()) <= 2.0 / np.sqrt(256) + 1e-6
    assert tuple(p["wo"].shape) == (5, 32, 256)


# --------------------------------------------------------------------------- #
# serving: chunked prefill, decode, the engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("quant", [False, True])
def test_prefill_chunk_and_decode_match_jax(quant):
    """Ragged chunks (slot 2 frozen, then slot 1) and decode waves with
    inactive slots past the 32-token ring: every row of a call, the frozen
    ones too, routes and takes capacity in both packages."""
    jcfg, tcfg, jp, tp = _setup("granite-moe-3b-a800m")
    if quant:
        jcfg = jcfg.replace(attention=dataclasses.replace(jcfg.attention,
                                                          kv_quant=True))
        tcfg = tcfg.replace(attention=tcfg.attention.replace(kv_quant=True))
    jc = jax_init(JT.cache_specs(jcfg, B, MAX_LEN), jax.random.PRNGKey(1))
    tc = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    jpre, jdec = _jax_fns(jcfg)
    for n, (kind, toks, arg) in enumerate(_schedule(jcfg.vocab, seed=2)):
        frozen = np.flatnonzero(arg == 0) if kind == "prefill" else \
            np.flatnonzero(~arg)
        before = {s: _frozen_rows(tc, s) for s in frozen}
        if kind == "prefill":
            jl, jc = jpre(jp, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg, jnp.int32))
            tl, tc = TT.prefill_chunk(tp, tcfg, tc, torch.as_tensor(toks),
                                      torch.as_tensor(arg, dtype=torch.int32))
            live = arg > 0
        else:
            jl, jc = jdec(jp, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg))
            tl, tc = TT.decode_step(tp, tcfg, tc, torch.as_tensor(toks),
                                    active=torch.as_tensor(arg))
            live = arg
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, err_msg=f"step {n} ({kind})")
        _cache_close(tc, jc, quant)
        for s, rows in before.items():
            _assert_rows_equal(tc, rows, s)
    assert int(tc["lengths"][0]) > MAX_LEN


def _greedy_mix():
    """tests/test_torch_engine.py's request set: ragged prompts, more
    requests than slots, one stream past the 64-token ring."""
    return [(np.arange(1, 20), 60), (np.array([5, 11, 2]), 4),
            (np.arange(2, 12), 9), (np.arange(7, 47), 6)]


@pytest.mark.parametrize("spec_k", [0, 3])
def test_greedy_streams_match_the_jax_engine(spec_k):
    jcfg, tcfg, jp, tp = _setup("granite-moe-3b-a800m")
    mix = _greedy_mix()
    jeng = JEngine(jcfg, jp, JEngineConfig(slots=3, max_len=64, chunk=8,
                                           spec_k=spec_k))
    ref = {len(r.prompt): np.asarray(r.out) for r in jeng.run(
        [JRequest(prompt=p, max_new_tokens=n) for p, n in mix])}
    eng = Engine(tcfg, tp, EngineConfig(slots=3, max_len=64, chunk=8,
                                        spec_k=spec_k), device="cpu")
    assert eng.model is TT
    got = {len(r.prompt): np.asarray(r.out) for r in eng.run(
        [Request(prompt=p, max_new_tokens=n) for p, n in mix])}
    assert set(got) == set(ref)
    for plen in ref:
        np.testing.assert_array_equal(got[plen], ref[plen],
                                      err_msg=f"prompt length {plen}")
    assert eng.telemetry.tags["family"] == "moe"
    if spec_k:
        assert eng.stats["spec_rounds"] == jeng.stats["spec_rounds"] > 0
        assert eng.stats["spec_accepted_tokens"] == \
            jeng.stats["spec_accepted_tokens"]


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", ["dense", "moe", "hubert", "internvl"])
def test_registry_serves_the_ported_families(family):
    cfg = get_smoke_config({"moe": "granite-moe-3b-a800m",
                            "hubert": "hubert-xlarge",
                            "internvl": "internvl2-1b"}.get(family,
                                                            "qwen3-1.7b"))
    assert cfg.family == family
    model = registry.get_model(cfg)
    assert model is TT
    for name in ("forward", "loss_fn", "cache_specs", "layer_cache_kinds",
                 "prefill", "prefill_chunk", "decode_step"):
        assert callable(getattr(model, name)), name


@pytest.mark.parametrize("family", ["rwkv6", "recurrentgemma"])
def test_registry_names_an_unported_family(family):
    """rwkv6 and recurrentgemma are ported (each its own module); a family
    the registry does not know raises naming it."""
    cfg = get_smoke_config("qwen3-1.7b").replace(family=family)
    assert registry.get_model(cfg).__name__ == f"repro_torch.models.{family}"
    with pytest.raises(ValueError, match="unknown model family 'mamba'"):
        registry.get_model(cfg.replace(family="mamba"))
