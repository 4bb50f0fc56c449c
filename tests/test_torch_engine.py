"""Port parity: repro_torch.serve (Engine, scheduler, cache, sampling).

The port's engine must emit the reference engine's greedy token streams
exactly: the qwen3-1.7b smoke config at fp32 activations, the reference's
weights carried over by ``params_from_jax``, ragged prompts, readmission
and generation past the ring capacity, ``kernel_mode="auto"`` (the
reference engine runs its jnp route, the port its kernel's plain twin on
the CPU). Sampled streams use another generator than JAX's PRNG, so they
are checked by their own contract (same seed -> same tokens, batched ==
solo) and by distribution (a chi-square test).

At ``levels = 3`` (the collapse-up hierarchy) the port's engine serves the
reference's long-context requests (prompts far past the 64-token window)
with the same greedy streams and the same final occupancy gauges.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model, init_params as jax_init
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro.serve import sampling as jsampling
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_jax
from repro_torch.serve import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    filtered_logits,
    sample_batch,
)
from repro_torch.serve.cache import RingPagedKVCache
from test_hier_pyramid import _long_reqs

ECFG = EngineConfig(slots=3, max_len=64, chunk=8)


@pytest.fixture(scope="module")
def cfgs():
    return (jax_smoke("qwen3-1.7b", activ_dtype="float32"),
            get_smoke_config("qwen3-1.7b", activ_dtype="float32"))


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, tcfg = cfgs
    jp = jax_init(get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), tcfg, device="cpu")


def _greedy_mix():
    """(prompt, max_new_tokens): ragged prompts, more requests than slots,
    and one stream that runs past the 64-token ring."""
    return [(np.arange(1, 20), 60), (np.array([5, 11, 2]), 4),
            (np.arange(2, 12), 9), (np.arange(7, 47), 6)]


def _run(engine_cls, req_cls, engine, mix, **kw):
    done = engine.run([req_cls(prompt=p, max_new_tokens=n, **kw) for p, n in mix])
    return {len(r.prompt): np.asarray(r.out) for r in done}


def test_greedy_streams_match_the_jax_engine(cfgs, params):
    jcfg, tcfg = cfgs
    jp, tp = params
    mix = _greedy_mix()
    ref = _run(JEngine, JRequest, JEngine(jcfg, jp, JEngineConfig(
        slots=3, max_len=64, chunk=8)), mix)
    eng = Engine(tcfg, tp, ECFG, device="cpu")
    got = _run(Engine, Request, eng, mix)
    assert set(got) == set(ref)
    for plen in ref:
        np.testing.assert_array_equal(got[plen], ref[plen],
                                      err_msg=f"prompt length {plen}")
    assert eng.kv.window_start()[0] >= 0
    assert eng.stats["requests_completed"] == len(mix)


@pytest.mark.parametrize("kind", ["full", "mra2_s"])
def test_other_attention_kinds_match_the_jax_engine(cfgs, params, kind):
    """Exact attention (dense cache, hard capacity) and MRA-2-s serve the
    reference's greedy tokens too."""
    jcfg, tcfg = cfgs
    jp, tp = params
    jcfg = jcfg.replace(attention=jcfg.attention.replace(kind=kind))
    tcfg = tcfg.replace(attention=tcfg.attention.replace(kind=kind))
    mix = [(np.arange(1, 20), 30), (np.array([5, 11, 2]), 4),
           (np.arange(2, 12), 9)]
    ref = _run(JEngine, JRequest, JEngine(jcfg, jp, JEngineConfig(
        slots=3, max_len=64, chunk=8)), mix)
    eng = Engine(tcfg, tp, ECFG, device="cpu")
    got = _run(Engine, Request, eng, mix)
    assert eng.kv.paged == (kind != "full")
    for plen in ref:
        np.testing.assert_array_equal(got[plen], ref[plen])


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_forced_kernel_modes_serve_the_same_tokens(cfgs, params, mode):
    _, tcfg = cfgs
    _, tp = params
    mix = _greedy_mix()[1:3]
    auto = _run(Engine, Request, Engine(tcfg, tp, ECFG, device="cpu"), mix)
    forced = _run(Engine, Request, Engine(
        tcfg, tp, ECFG.replace(kernel_mode=mode), device="cpu"), mix)
    for plen in auto:
        np.testing.assert_array_equal(forced[plen], auto[plen])


def _sampled_requests():
    return [Request(prompt=np.arange(1, 20), max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.9, seed=7)),
            Request(prompt=np.array([5, 11, 2]), max_new_tokens=3,
                    sampling=SamplingParams(temperature=1.0, top_k=5, seed=3)),
            Request(prompt=np.arange(2, 12), max_new_tokens=4),
            Request(prompt=np.arange(3, 9), max_new_tokens=5,
                    sampling=SamplingParams(temperature=0.7, top_p=0.9,
                                            seed=11))]


def test_batched_equals_solo_with_readmission(cfgs, params):
    """More requests than slots (freed slots readmit mid-flight); every
    request's tokens equal its solo run, sampled ones included."""
    _, tcfg = cfgs
    _, tp = params
    batched = Engine(tcfg, tp, ECFG.replace(slots=2), device="cpu").run(
        _sampled_requests())
    by_plen = {len(r.prompt): r.out for r in batched}
    for req in _sampled_requests():
        solo = Engine(tcfg, tp, ECFG, device="cpu").run([req])[0]
        np.testing.assert_array_equal(solo.out, by_plen[len(req.prompt)])
        assert len(solo.out) == req.max_new_tokens


def test_same_seed_same_sampled_tokens(cfgs, params):
    _, tcfg = cfgs
    _, tp = params

    def run(seed):
        return Engine(tcfg, tp, ECFG, device="cpu").run([Request(
            prompt=np.arange(1, 9), max_new_tokens=8,
            sampling=SamplingParams(temperature=1.5, seed=seed))])[0].out

    np.testing.assert_array_equal(run(5), run(5))
    assert not np.array_equal(run(5), run(6))


def test_degenerate_requests_and_capacity(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    eng = Engine(tcfg, tp, ECFG.replace(slots=2), device="cpu")
    done = eng.run([Request(prompt=np.array([], np.int32), max_new_tokens=4),
                    Request(prompt=np.array([3, 4]), max_new_tokens=0)])
    assert len(done) == 2 and all(len(r.out) == 0 for r in done)
    assert eng.stats["prefill_dispatches"] == 0
    assert eng.stats["decode_dispatches"] == 0
    with pytest.raises(ValueError, match="capacity"):
        eng.run([Request(prompt=np.arange(100), max_new_tokens=1)])


def test_chunked_prefill_dispatch_economy(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    eng = Engine(tcfg, tp, ECFG.replace(slots=2), device="cpu")
    eng.run([Request(prompt=np.arange(1, 25), max_new_tokens=3),
             Request(prompt=np.arange(1, 6), max_new_tokens=3)])
    assert eng.stats["prefill_dispatches"] == 3  # ceil(24 / 8)
    assert eng.stats["decode_dispatches"] <= 4
    assert eng.stats["prefill_tokens"] == 29
    assert eng.stats["generated_tokens"] == 6


def test_ring_eviction_generates_past_capacity(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    eng = Engine(tcfg, tp, EngineConfig(slots=1, max_len=32, chunk=8),
                 device="cpu")
    out = eng.run([Request(prompt=np.arange(1, 9), max_new_tokens=40)])[0].out
    assert len(out) == 40 and int(np.max(out)) < tcfg.vocab
    assert eng.kv.lengths[0] == 8 + 40 - 1  # last sampled token never fed
    pb = eng.kv.tree["page_blocks"][0].numpy()
    assert (pb >= 0).sum() == eng.kv.pages
    assert pb.max() == (eng.kv.lengths[0] - 1) // eng.kv.block
    assert eng.kv.window_start()[0] == pb.min() * eng.kv.block
    occ = eng.kv.occupancy()
    assert occ["tokens_evicted"] == eng.kv.window_start()[0]
    assert occ["pages_live"] == eng.kv.pages


@pytest.mark.parametrize("seed", range(3))
def test_filtered_logits_match_jax(seed):
    """Same support and values as the reference. Logits at unit scale keep
    every probability far above fp32 resolution: an entry of probability
    < 6e-8 sits where ``csum - p < top_p`` depends on how the cumsum
    rounds, which differs between the frameworks."""
    r = np.random.default_rng(seed)
    B, V = 6, 40
    logits = r.standard_normal((B, V)).astype(np.float32)
    temp = np.array([0.7, 1.0, 1.3, 2.0, 0.5, 1.0], np.float32)
    top_k = np.array([0, 5, 1, 0, 12, 40], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.0, 0.8], np.float32)
    ref = np.asarray(jsampling.filtered_logits(
        jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
        jnp.asarray(top_p), vocab=37))
    got = filtered_logits(torch.from_numpy(logits), temp, top_k, top_p,
                          vocab=37).numpy()
    support = ref > -1e8
    np.testing.assert_array_equal(got > -1e8, support)
    # off the support both hold a -1e9-scale sentinel (probability 0); which
    # one (NEG_INF or NEG_INF / T) depends on the same cumsum rounding
    np.testing.assert_allclose(np.where(support, got, 0.0),
                               np.where(support, ref, 0.0), rtol=1e-6, atol=1e-6)


def test_greedy_and_degenerate_samplers_pick_the_argmax():
    r = np.random.default_rng(0)
    logits = torch.from_numpy(r.standard_normal((3, 32)).astype(np.float32))
    greedy = logits[:, :20].argmax(-1)
    got = sample_batch(logits, [1.3, 0.7, 0.0], [1, 0, 0], [1.0, 1e-6, 1.0],
                       [5, 9, 4], [0, 0, 0], vocab=20)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())


def test_sampled_distribution_chi_square():
    """Draws over (seed, step) follow softmax(logits / T) over a small vocab:
    Pearson chi-square below the 0.1% critical value for 7 degrees of
    freedom (24.32)."""
    r = np.random.default_rng(1)
    V, n, T = 8, 4000, 0.8
    logits = r.standard_normal(V).astype(np.float32)
    p = np.exp(logits / T - (logits / T).max())
    p /= p.sum()
    lg = torch.from_numpy(np.tile(logits, (n, 1)))
    toks = sample_batch(lg, np.full(n, T), np.zeros(n, int), np.ones(n),
                        np.arange(n) % 7, np.arange(n) // 7).numpy()
    counts = np.bincount(toks, minlength=V)
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < 24.32, (chi2, counts, n * p)


def test_engine_needs_cuda_or_an_explicit_cpu(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tcfg, tp, ECFG)


class _OneRank:
    """A (1, 1) mesh stand-in: the placement rules read its ``shape``,
    the block cutters a rank's ``index`` on an axis."""

    shape = {"data": 1, "model": 1}

    def index(self, axis):
        return 0


@pytest.mark.parametrize("field,value", [("mesh", _OneRank()),
                                         ("draft_level", 2)])
def test_unported_options_raise(cfgs, params, field, value):
    """draft_level 2 builds (the grouped far-field draft is ported) and a
    draft_level below 1 raises. A mesh serves every family now: the
    recurrent families' state caches too (tests/test_torch_dist_recurrent.py),
    so rwkv6 builds on a one-rank mesh, its tree whole and placed by the
    rules, and raises only for speculation, which its state cache lacks."""
    _, tcfg = cfgs
    _, tp = params
    if field == "mesh":
        cfg = get_smoke_config("rwkv6-7b")
        from repro_torch.models.params import init_params

        rp = init_params(cfg, seed=0, device="cpu")
        eng = Engine(cfg, rp, ECFG.replace(mesh=value), device="cpu")
        assert eng.kv.mesh is value and not eng.kv.row_split
        assert eng.kv.tree["state"].shape[1] == ECFG.slots
        with pytest.raises(NotImplementedError, match="speculative"):
            Engine(cfg, rp, ECFG.replace(mesh=value, spec_k=2), device="cpu")
        return
    eng = Engine(tcfg, tp, ECFG.replace(spec_k=2, **{field: value}),
                 device="cpu")
    assert eng._spec.dcfg.attention.draft_level == value
    with pytest.raises(ValueError, match=field):
        Engine(tcfg, tp, ECFG.replace(**{field: 0}), device="cpu")
    with pytest.raises(ValueError, match="kernel_mode"):
        Engine(tcfg, tp, ECFG.replace(kernel_mode="fast"), device="cpu")


@pytest.mark.parametrize("family", ["rwkv6", "recurrentgemma"])
def test_unported_family_raises(cfgs, params, family):
    """The engine takes its model and its cache from the registry: rwkv6
    builds over the recurrent state, recurrentgemma over the window ring +
    RG-LRU state with the chunk clamped to the window (every family is
    ported now); a family the registry does not know raises naming it."""
    _, tcfg = cfgs
    _, tp = params
    if family == "rwkv6":
        eng = Engine(tcfg.replace(family=family), tp, ECFG, device="cpu")
        assert type(eng.kv).__name__ == "RecurrentStateCache"
    else:
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.params import init_params

        cfg = get_smoke_config("recurrentgemma-9b")
        eng = Engine(cfg, init_params(cfg, seed=0, device="cpu"),
                     ECFG.replace(max_len=64, chunk=48), device="cpu")
        assert type(eng.kv).__name__ == "HybridWindowCache"
        assert eng.chunk == eng.kv.chunk_cap == cfg.local_window
    with pytest.raises(ValueError, match="mamba"):
        Engine(tcfg.replace(family="mamba"), tp, ECFG, device="cpu")


def test_engine_builds_for_hubert_as_the_reference():
    """hubert is an encoder (no decode shapes of its own), yet the
    reference's engine builds for it, since the registry gives it the
    transformer's serving entry points; the port's does too, with the
    same cache layout."""
    jcfg = jax_smoke("hubert-xlarge", activ_dtype="float32")
    tcfg = get_smoke_config("hubert-xlarge", activ_dtype="float32")
    jp = jax_init(get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(0))
    jeng = JEngine(jcfg, jp, JEngineConfig(slots=3, max_len=64, chunk=8))
    eng = Engine(tcfg, params_from_jax(jax.device_get(jp), tcfg,
                                       device="cpu"), ECFG, device="cpu")
    assert eng.model is TT
    assert TT.layer_cache_kinds(tcfg) == jeng.model.layer_cache_kinds(jcfg)
    want = {k: [tuple(s.shape) for s in v] if isinstance(v, list)
            else tuple(v.shape) for k, v in jeng.kv.specs.items()}
    got = {k: [tuple(t.shape) for t in v] if isinstance(v, list)
           else tuple(v.shape) for k, v in eng.kv.tree.items()}
    assert got == want


# --------------------------------------------------------------------------- #
# H = 3: serving past the fine window
# --------------------------------------------------------------------------- #
H3_ECFG = EngineConfig(slots=2, max_len=64, chunk=32)


def _h3(cfgs):
    return tuple(c.replace(attention=c.attention.replace(levels=3))
                 for c in cfgs)


def _port_long_reqs():
    return [Request(prompt=np.asarray(r.prompt), max_new_tokens=r.max_new_tokens)
            for r in _long_reqs()]


def test_h3_streams_and_occupancy_match_the_jax_engine(cfgs, params):
    jcfg, tcfg = _h3(cfgs)
    jp, tp = params
    jeng = JEngine(jcfg, jp, JEngineConfig(slots=2, max_len=64, chunk=32))
    ref = {len(r.prompt): np.asarray(r.out) for r in jeng.run(_long_reqs())}
    eng = Engine(tcfg, tp, H3_ECFG, device="cpu")
    got = {len(r.prompt): np.asarray(r.out) for r in eng.run(_port_long_reqs())}
    assert eng.kv.capacity is None and eng.kv.chunk_cap == 48
    assert set(got) == set(ref)
    for plen in ref:
        np.testing.assert_array_equal(got[plen], ref[plen],
                                      err_msg=f"prompt length {plen}")
    occ, jocc = eng.kv.occupancy(), jeng.kv.occupancy()
    assert occ == jocc
    assert occ["level2_entries"] > 0 and occ["tail_tokens"] > 0
    # every token of each slot is live, collapsed or in the tail, once
    lengths = eng.kv.lengths
    live = lengths - eng.kv.window_start()
    held = (eng.kv.tree["hier_cnt2"].sum(-1) + eng.kv.tree["tail_cnt"]).numpy()
    np.testing.assert_array_equal(live + held, lengths)
    assert (live <= 64).all()


def test_h3_block_aligned_chunks_match_sequential_decode(cfgs, params):
    """Chunks of one block evict only at their own start — the sequential
    schedule — so greedy tokens equal token-by-token decode replay."""
    _, tcfg = _h3(cfgs)
    _, tp = params
    prompt = (np.arange(1, 201) % 512).astype(np.int64)
    n_new = 8
    eng = Engine(tcfg, tp, H3_ECFG.replace(slots=1, chunk=16), device="cpu")
    out = eng.run([Request(prompt=prompt, max_new_tokens=n_new)])[0].out
    cache = RingPagedKVCache(tcfg, 1, 64, device="cpu").tree
    for t in prompt:
        logits, _ = TT.decode_step(tp, tcfg, cache, torch.tensor([t]))
    oracle = []
    for _ in range(n_new):
        tok = int(torch.argmax(logits[0, :tcfg.vocab]))
        oracle.append(tok)
        logits, _ = TT.decode_step(tp, tcfg, cache, torch.tensor([tok]))
    np.testing.assert_array_equal(out, np.array(oracle))
    assert int(cache["tail_cnt"][0]) > 0


def test_h2_engine_still_rejects_a_prompt_past_the_window(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    eng = Engine(tcfg, tp, H3_ECFG.replace(slots=1), device="cpu")
    assert eng.kv.capacity == 64 and eng.kv.chunk_cap is None
    with pytest.raises(ValueError, match="capacity"):
        eng.run([Request(prompt=np.arange(100), max_new_tokens=1)])
    assert not any(k.startswith(("level", "tail")) for k in eng.kv.occupancy())
