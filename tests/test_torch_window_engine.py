"""Port parity: the engine serving recurrentgemma through the window cache.

Mirrors the recurrentgemma cases of the reference's
tests/test_recurrent_engine.py and tests/test_registry_contract.py on the
port, at the recurrentgemma-9b smoke config (window 32) on the CPU:

  * greedy token streams equal the JAX engine's (fp32 activations, the
    reference's weights through ``params_from_jax``), for the ``local``
    preset and the MRA-2 variant, with prompts past the window, more
    requests than slots and streams past ``max_len``;
  * batched equals solo with readmission (5 requests through 2 slots,
    greedy and sampled), chunked-prefill dispatch economy with the chunk
    clamped to the window, generation past ``max_len`` (the ring keeps the
    last W tokens: no capacity), degenerate requests, ``spec_k`` refused,
    and the window-wrap stress (a generation crossing the ring's wrap in a
    shared batch equals a stepwise ``decode_step`` replay);
  * the serving contract: the entry points' signatures equal the
    transformer module's, ``layer_cache_kinds`` follows the block pattern,
    ``make_cache`` builds a ``HybridWindowCache`` with ``chunk_cap`` =
    min(window, max_len), ``decode_step``'s ``active`` mask freezes a slot
    bitwise, ``prefill_chunk`` with ``num_valid == 0`` is the identity,
    ``reset_slots`` equals a fresh cache bitwise (``kv_pos`` back to -1),
    and the occupancy gauges count the ring.
"""
from __future__ import annotations

import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core.attention import AttentionSpec as JSpec
from repro.models import init_params as jax_init
from repro.models import recurrentgemma as JR
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.core.attention import AttentionSpec as TSpec
from repro_torch.models import recurrentgemma as TR
from repro_torch.models import transformer as TT
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.serve import (Engine, EngineConfig, Request, SamplingParams,
                               make_cache)
from repro_torch.serve.cache import HybridWindowCache, StateCache

ARCH = "recurrentgemma-9b"
SERVING_API = ("cache_specs", "layer_cache_kinds", "prefill", "prefill_chunk",
               "decode_step")
MRA = dict(kind="mra2", block_size=16, blocks_per_row=2)


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config(ARCH)
    return cfg, init_params(cfg, seed=0, device="cpu")


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
@pytest.mark.parametrize("mra", [False, True], ids=["local", "mra2"])
def test_greedy_streams_match_the_jax_engine(mra):
    """Ragged prompts past the 32-token window, more requests than slots,
    streams past max_len; chunk 24 (< the window)."""
    kw = dict(activ_dtype="float32")
    jcfg = jax_smoke(ARCH, **kw, **({"attention": JSpec(**MRA)} if mra else {}))
    tcfg = get_smoke_config(ARCH, **kw,
                            **({"attention": TSpec(**MRA)} if mra else {}))
    jp = jax_init(JR.param_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    mix = [(np.arange(1, 60), 12), (np.array([5, 11, 2]), 4),
           (np.arange(2, 12), 40), (np.arange(7, 47), 6)]
    ecfg = dict(slots=3, max_len=48, chunk=24)
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
    assert type(eng.kv) is HybridWindowCache and eng.kv.capacity is None
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
    """The chunk is clamped to the window (64 asked, 32 held), and three
    90-token prompts take at most ceil(90 / 32) dispatches a wave."""
    cfg, params = setup
    eng = _engine(cfg, params, slots=3, max_len=64, chunk=64)
    assert eng.chunk == eng.kv.chunk_cap == cfg.local_window == 32
    eng.run(_reqs(_prompts(cfg, [30, 30, 30]), n_new=2))
    tokens = eng.stats["prefill_tokens"]
    dispatches = eng.stats["prefill_dispatches"]
    assert tokens == 90
    assert dispatches * 5 <= tokens, (dispatches, tokens)


def test_unbounded_generation_past_max_len(setup):
    cfg, params = setup
    eng = _engine(cfg, params, slots=1, max_len=16, chunk=8)
    assert eng.kv.chunk_cap == 16  # W = min(window, max_len)
    reqs = [Request(prompt=_prompts(cfg, [40])[0], max_new_tokens=12)]
    eng.run(reqs)
    assert len(reqs[0].out) == 12
    assert eng.kv.lengths[0] == 40 + 11  # the last token is never fed
    occ = eng.kv.occupancy()
    assert occ["tokens_live"] == 16.0 and occ["tokens_evicted"] == 35.0


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
    mra = cfg.replace(attention=TSpec(**MRA))
    with pytest.raises(NotImplementedError, match="ring-paged"):
        _engine(mra, params, slots=1, max_len=32, spec_k=2)


def test_hybrid_window_wrap_stress(setup):
    """Greedy generation crossing the ring's wrap (len > W = 32) inside a
    shared batch equals a stepwise ``decode_step`` replay of one lane."""
    cfg, params = setup
    prompt = _prompts(cfg, [28])[0]
    eng = _engine(cfg, params, slots=2, max_len=64, chunk=8)
    req = Request(prompt=prompt.copy(), max_new_tokens=10)
    decoy = Request(prompt=_prompts(cfg, [17], seed=5)[0], max_new_tokens=10)
    eng.run([req, decoy])
    cache = HybridWindowCache(cfg, TR, 1, 64, device="cpu").tree
    with torch.no_grad():
        for t in prompt:
            lg, cache = TR.decode_step(params, cfg, cache, torch.tensor([int(t)]))
        toks = []
        t = int(torch.argmax(lg[0]))
        for _ in range(10):
            toks.append(t)
            lg, cache = TR.decode_step(params, cfg, cache, torch.tensor([t]))
            t = int(torch.argmax(lg[0]))
    np.testing.assert_array_equal(req.out, np.array(toks, np.int32))


# --------------------------------------------------------------------------- #
# the reference's registry-contract cases
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fn", SERVING_API)
def test_signatures_match_transformer_reference(fn):
    want = inspect.signature(getattr(TT, fn))
    got = inspect.signature(getattr(TR, fn))
    assert ([(p.name, p.kind, p.default) for p in got.parameters.values()]
            == [(p.name, p.kind, p.default) for p in want.parameters.values()])


def test_layer_cache_kinds_follow_the_pattern(setup):
    cfg, _ = setup
    assert get_model(cfg) is TR
    assert TR.layer_cache_kinds(cfg) == ["rglru", "rglru", "window"]
    seven = cfg.replace(num_layers=7)
    assert TR.layer_cache_kinds(seven) == ["rglru", "rglru", "window"] * 2 + [
        "rglru"]
    assert TR.layer_cache_kinds(cfg.replace(block_pattern=("local",))) == [
        "window"] * 3


def test_cache_factory_builds_the_window_cache(setup):
    cfg, _ = setup
    cache = make_cache(cfg, TR, 2, 20, device="cpu")
    assert type(cache) is HybridWindowCache and isinstance(cache, StateCache)
    assert cache.kinds == tuple(TR.layer_cache_kinds(cfg))
    assert cache.chunk_cap == 20 and not cache.paged
    assert not cache.supports_spec and cache.capacity is None
    assert tuple(cache.tree["k"].shape) == (1, 2, 1, 20, cfg.hd)
    assert tuple(cache.tree["h"].shape) == (2, 2, cfg.lru_width)
    assert tuple(cache.tree["conv"].shape) == (2, 2, 3, cfg.lru_width)
    with pytest.raises(NotImplementedError):
        cache.spec_snapshot(window=4)


def _cache(cfg, B):
    return HybridWindowCache(cfg, TR, B, 64, device="cpu")


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


def test_decode_step_on_a_frozen_empty_slot_writes_nothing(setup):
    """A slot never admitted (length 0) and frozen: its position is -1, whose
    ring entry (W - 1) must keep -1 and zeros."""
    cfg, params = setup
    kv = _cache(cfg, 2)
    fresh = _clone(kv.tree)
    with torch.no_grad():
        TR.decode_step(params, cfg, kv.tree, torch.tensor([3, 4]),
                       active=torch.tensor([True, False]))
    for key, a in kv.tree.items():
        axis = 0 if key == "lengths" else 1
        assert torch.equal(a.select(axis, 1), fresh[key].select(axis, 1)), key


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
    assert int(kv.tree["kv_pos"][:, 0].max()) == -1
    assert kv.occupancy() == {"slots_active": 1.0, "tokens_live": 8.0,
                              "pages_live": 8.0, "tokens_evicted": 0.0}
