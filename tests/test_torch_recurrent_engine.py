"""Port parity: the engine serving rwkv6 through the recurrent state cache.

Mirrors the rwkv6 cases of the reference's tests/test_recurrent_engine.py
and tests/test_registry_contract.py on the port, at the rwkv6-7b smoke
config on the CPU:

  * greedy token streams equal the JAX engine's (fp32 activations, the
    reference's weights through ``params_from_jax``), readmission and a
    stream past ``max_len`` included;
  * batched equals solo with readmission (5 requests through 2 slots,
    greedy and sampled), chunked-prefill dispatch economy, generation past
    ``max_len`` (the recurrent state has no capacity), default sampling,
    degenerate requests, and ``spec_k`` refused;
  * the serving contract: the entry points' signatures equal the
    transformer module's, ``layer_cache_kinds`` is ``["wkv"] * L``,
    ``make_cache`` routes by kind (recurrentgemma's window kinds to the
    hybrid window cache) and refuses a mix no backend serves,
    ``decode_step``'s ``active`` mask freezes a
    slot bitwise, ``prefill_chunk`` with ``num_valid == 0`` is the
    identity, and ``reset_slots`` equals a fresh cache bitwise.
"""
from __future__ import annotations

import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.models import rwkv6 as JR
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.models import rwkv6 as TR
from repro_torch.models import transformer as TT
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serve import (Engine, EngineConfig, Request, SamplingParams,
                               make_cache)
from repro_torch.serve.cache import (HybridWindowCache, RecurrentStateCache,
                                     RingPagedKVCache, StateCache)
from repro_torch.serve.cache.protocol import fill_value

ARCH = "rwkv6-7b"
SERVING_API = ("cache_specs", "layer_cache_kinds", "prefill", "prefill_chunk",
               "decode_step")


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    return cfg, init_params(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def fp32():
    jcfg = jax_smoke(ARCH, activ_dtype="float32")
    tcfg = get_smoke_config(ARCH, activ_dtype="float32")
    jp = jax_init(JR.param_specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.device_get(jp), tcfg,
                                           device="cpu")


def _prompts(cfg, lens, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, (n,)).astype(np.int32) for n in lens]


def _reqs(prompts, n_new=6):
    out = []
    for i, p in enumerate(prompts):
        sp = (SamplingParams() if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=8, seed=40 + i))
        out.append(Request(prompt=p.copy(), max_new_tokens=n_new, sampling=sp))
    return out


def _engine(cfg, params, **kw):
    return Engine(cfg, params, EngineConfig(**kw), device="cpu")


# --------------------------------------------------------------------------- #
# against the JAX engine
# --------------------------------------------------------------------------- #
def test_greedy_streams_match_the_jax_engine(fp32):
    """Ragged prompts, more requests than slots, one stream past max_len."""
    jcfg, tcfg, jp, tp = fp32
    mix = [(np.arange(1, 20), 50), (np.array([5, 11, 2]), 4),
           (np.arange(2, 12), 9), (np.arange(7, 47), 6)]
    ecfg = dict(slots=3, max_len=48, chunk=8)
    ref = {len(r.prompt): np.asarray(r.out) for r in JEngine(
        jcfg, jp, JEngineConfig(**ecfg)).run(
            [JRequest(prompt=p, max_new_tokens=n) for p, n in mix])}
    eng = _engine(tcfg, tp, **ecfg)
    got = {len(r.prompt): np.asarray(r.out) for r in eng.run(
        [Request(prompt=p, max_new_tokens=n) for p, n in mix])}
    assert set(got) == set(ref)
    for plen in ref:
        np.testing.assert_array_equal(got[plen], ref[plen],
                                      err_msg=f"prompt length {plen}")
    assert type(eng.kv) is RecurrentStateCache and eng.kv.capacity is None
    assert eng.stats["requests_completed"] == len(mix)


# --------------------------------------------------------------------------- #
# the reference's recurrent-engine cases
# --------------------------------------------------------------------------- #
def test_batched_equals_solo_with_readmission(setup):
    cfg, params = setup
    prompts = _prompts(cfg, [19, 40, 3, 27, 11])
    batched = _reqs(prompts)
    _engine(cfg, params, slots=2, max_len=64, chunk=16).run(batched)
    solo = _engine(cfg, params, slots=1, max_len=64, chunk=16)
    for i, (p, rb) in enumerate(zip(prompts, batched)):
        rs = _reqs([p])[0]
        rs.sampling = batched[i].sampling
        solo.run([rs])
        np.testing.assert_array_equal(rb.out, rs.out)


def test_chunked_prefill_dispatch_economy(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=3, max_len=64, chunk=16)
    eng.run(_reqs(_prompts(cfg, [30, 30, 30]), n_new=2))
    tokens = eng.stats["prefill_tokens"]
    dispatches = eng.stats["prefill_dispatches"]
    assert tokens == 90
    assert dispatches * 5 <= tokens, (dispatches, tokens)


def test_unbounded_generation_past_max_len(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=1, max_len=16, chunk=8)
    reqs = [Request(prompt=_prompts(cfg, [40])[0], max_new_tokens=12)]
    eng.run(reqs)
    assert len(reqs[0].out) == 12
    assert eng.kv.lengths[0] == 40 + 11  # the last token is never fed


def test_default_sampling_resolution(setup):
    cfg, params = setup
    prompt = _prompts(cfg, [13])[0]
    sp = SamplingParams(temperature=0.7, top_k=4, seed=9)
    r1 = Request(prompt=prompt.copy(), max_new_tokens=6)
    _engine(cfg, params, slots=1, max_len=64, chunk=8,
            default_sampling=sp).run([r1])
    r2 = Request(prompt=prompt.copy(), max_new_tokens=6, sampling=sp)
    _engine(cfg, params, slots=1, max_len=64, chunk=8).run([r2])
    np.testing.assert_array_equal(r1.out, r2.out)


def test_degenerate_requests(setup):
    cfg, params = setup
    prompt = _prompts(cfg, [9])[0]
    eng = _engine(cfg, params, slots=2, max_len=64, chunk=8)
    reqs = [Request(prompt=np.array([], np.int32), max_new_tokens=4),
            Request(prompt=prompt, max_new_tokens=5),
            Request(prompt=prompt.copy(), max_new_tokens=0)]
    eng.run(reqs)
    assert len(reqs[0].out) == 0 and len(reqs[2].out) == 0
    assert len(reqs[1].out) == 5
    ref = Request(prompt=prompt.copy(), max_new_tokens=5)
    _engine(cfg, params, slots=1, max_len=64, chunk=8).run([ref])
    np.testing.assert_array_equal(reqs[1].out, ref.out)


def test_spec_decoding_rejected(setup):
    cfg, params = setup
    with pytest.raises((NotImplementedError, ValueError)):
        _engine(cfg, params, slots=1, max_len=32, spec_k=2)
    # the backend itself refuses too, whatever the attention kind says
    mra = cfg.replace(attention=cfg.attention.replace(kind="mra2"))
    with pytest.raises(NotImplementedError, match="ring-paged"):
        _engine(mra, params, slots=1, max_len=32, spec_k=2)


# --------------------------------------------------------------------------- #
# the reference's registry-contract cases
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fn", SERVING_API)
def test_signatures_match_transformer_reference(fn):
    want = inspect.signature(getattr(TT, fn))
    got = inspect.signature(getattr(TR, fn))
    assert ([(p.name, p.kind, p.default) for p in got.parameters.values()]
            == [(p.name, p.kind, p.default) for p in want.parameters.values()])


def test_layer_cache_kinds_well_formed(setup):
    cfg, _ = setup
    assert get_model(cfg) is TR
    assert TR.layer_cache_kinds(cfg) == ["wkv"] * cfg.num_layers


@pytest.mark.parametrize("arch,backend", [(ARCH, RecurrentStateCache),
                                          ("qwen3-1.7b", RingPagedKVCache),
                                          ("recurrentgemma-9b",
                                           HybridWindowCache)])
def test_cache_factory_routes_by_kinds(arch, backend):
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    cache = make_cache(cfg, model, 2, 32, device="cpu")
    assert type(cache) is backend
    assert cache.kinds == tuple(model.layer_cache_kinds(cfg))
    assert cache.lengths.shape == (2,)
    assert isinstance(cache.paged, bool)
    assert cache.supports_spec == (backend is RingPagedKVCache)
    if not cache.supports_spec:
        with pytest.raises(NotImplementedError):
            cache.spec_snapshot(window=4)


@pytest.mark.parametrize("kinds", [["window", "wkv"], ["wkv", "kv"]])
def test_cache_factory_refuses_unserved_kinds(setup, kinds):
    """A mix of kinds no one backend holds (the window ring with the wkv
    state, the wkv state with paged K/V) is refused; the window kinds alone
    are served (``test_cache_factory_routes_by_kinds``)."""
    cfg, _ = setup

    class Model:
        @staticmethod
        def layer_cache_kinds(cfg):
            return kinds

    with pytest.raises(ValueError, match="no cache backend"):
        make_cache(cfg, Model, 2, 32, device="cpu")


def _cache(cfg, B):
    return RecurrentStateCache(cfg, TR, B, 32, device="cpu")


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def test_decode_step_active_mask_freezes_slots_bitwise(setup):
    cfg, params = setup
    B, S = 3, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (B, S)).astype(np.int32))
    kv = _cache(cfg, B)
    with torch.no_grad():
        TR.prefill_chunk(params, cfg, kv.tree, toks, torch.full((B,), S))
        before = _clone(kv.tree)
        TR.decode_step(params, cfg, kv.tree, torch.tensor([5, 6, 7]),
                       active=torch.tensor([True, False, True]))
    for key, a in kv.tree.items():
        axis = 0 if key == "lengths" else 1
        assert torch.equal(a.select(axis, 1), before[key].select(axis, 1)), key
        assert not torch.equal(a.select(axis, 0), before[key].select(axis, 0))


def test_prefill_chunk_zero_valid_is_identity(setup):
    cfg, params = setup
    B = 2
    kv = _cache(cfg, B)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (B, 8)).astype(np.int32))
    with torch.no_grad():
        TR.prefill_chunk(params, cfg, kv.tree, toks, torch.full((B,), 8))
        before = _clone(kv.tree)
        TR.prefill_chunk(params, cfg, kv.tree, torch.zeros((B, 8),
                                                           dtype=torch.int64),
                         torch.zeros((B,), dtype=torch.int32))
    for key in before:
        assert torch.equal(kv.tree[key], before[key]), key


def test_reset_slots_equals_a_fresh_cache(setup):
    cfg, params = setup
    kv = _cache(cfg, 3)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab, (3, 8)).astype(np.int32))
    with torch.no_grad():
        TR.prefill_chunk(params, cfg, kv.tree, toks, torch.full((3,), 8))
    kept = _clone(kv.tree)
    kv.reset_slots(np.array([True, False, True]))
    fresh = _cache(cfg, 3).tree
    for key, a in kv.tree.items():
        axis = 0 if key == "lengths" else 1
        for s in (0, 2):
            assert torch.equal(a.select(axis, s), fresh[key].select(axis, s))
        assert torch.equal(a.select(axis, 1), kept[key].select(axis, 1))
    assert isinstance(kv, StateCache) and kv.capacity is None
    assert kv.occupancy() == {"slots_active": 1.0, "tokens_live": 8.0,
                              "pages_live": 0.0, "tokens_evicted": 0.0}
    assert {fill_value(s) for s in kv.specs.values()} == {0.0}
