"""Port parity: resolution-speculative decoding (repro_torch.serve.speculative).

The port's speculative engine must emit the reference engine's greedy
streams exactly — and the plain engine's — with the same round, draft,
accept and dispatch counters: the qwen3-1.7b smoke config at fp32, the
reference's weights via ``params_from_jax``, ragged prompts, readmission
and a stream past the 64-token ring (``_greedy_mix``), and at ``levels=3``
prompts far past the window with generation across block boundaries.

The snapshot -> draft -> rewind pair must leave every cache tensor
bitwise as it was (bf16 and int8 caches, H = 2 and H = 3), ``collect_kv``
must return the reference's chunk K/V, and the accept primitives must
agree with the reference on the same numpy inputs and emit the target
distribution. Sampled speculation draws from another generator than JAX's
PRNG, so it is checked by its own contract (same seed -> same tokens,
batched == solo).
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
from repro.serve.cache import RingPagedKVCache as JRingPagedKVCache
from repro.serve.speculative import SpecDecoder as JSpecDecoder
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import chunk_attn
from repro_torch.models import transformer as TT
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams
from repro_torch.serve import sampling as tsampling
from repro_torch.serve.cache import RingPagedKVCache
from repro_torch.serve.speculative import SpecDecoder, draft_config
from test_torch_engine import _greedy_mix, _run

ECFG = EngineConfig(slots=3, max_len=64, chunk=8)
SPEC_COUNTERS = ("spec_rounds", "spec_drafted_tokens", "spec_accepted_tokens",
                 "spec_emitted_tokens", "draft_dispatches", "verify_dispatches",
                 "decode_dispatches", "prefill_dispatches", "generated_tokens")


@pytest.fixture(scope="module")
def cfgs():
    return (jax_smoke("qwen3-1.7b", activ_dtype="float32"),
            get_smoke_config("qwen3-1.7b", activ_dtype="float32"))


@pytest.fixture(scope="module")
def params(cfgs):
    jcfg, tcfg = cfgs
    jp = jax_init(get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.device_get(jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def plain_streams(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    return _run(Engine, Request, Engine(tcfg, tp, ECFG, device="cpu"),
                _greedy_mix())


@pytest.mark.parametrize("spec_k", [2, 3, 4])
def test_greedy_spec_streams_and_counters_match_the_jax_engine(
        cfgs, params, plain_streams, spec_k):
    jcfg, tcfg = cfgs
    jp, tp = params
    mix = _greedy_mix()
    jeng = JEngine(jcfg, jp, JEngineConfig(slots=3, max_len=64, chunk=8,
                                           spec_k=spec_k))
    ref = _run(JEngine, JRequest, jeng, mix)
    eng = Engine(tcfg, tp, ECFG.replace(spec_k=spec_k), device="cpu")
    got = _run(Engine, Request, eng, mix)
    assert set(got) == set(ref) == set(plain_streams)
    for plen in ref:
        np.testing.assert_array_equal(got[plen], ref[plen],
                                      err_msg=f"prompt length {plen}")
        np.testing.assert_array_equal(got[plen], plain_streams[plen])
    for key in SPEC_COUNTERS:
        assert eng.stats[key] == jeng.stats[key], key
    # rounds ran, some drafts were rejected (the trim rewind ran), and the
    # stream past the ring took plain waves at its block crossings
    assert 0 < eng.stats["spec_accepted_tokens"] < eng.stats["spec_drafted_tokens"]
    assert eng.stats["verify_dispatches"] == eng.stats["spec_rounds"]
    assert eng.stats["draft_dispatches"] == spec_k * eng.stats["spec_rounds"]


def _park(tcfg, tp, kv_quant=False, levels=2):
    """An engine whose slot lengths sit at 30 and 12 of a 32-token window."""
    cfg = tcfg.replace(attention=tcfg.attention.replace(kv_quant=kv_quant,
                                                        levels=levels))
    eng = Engine(cfg, tp, EngineConfig(slots=2, max_len=32, chunk=8),
                 device="cpu")
    eng.run([Request(prompt=np.arange(1, 9), max_new_tokens=23),
             Request(prompt=np.arange(3, 9), max_new_tokens=7)])
    return cfg, eng


def _flat(tree):
    return {f"{k}[{i}]" if isinstance(v, list) else k: a.clone()
            for k, v in tree.items()
            for i, a in (enumerate(v) if isinstance(v, list) else [(0, v)])}


@pytest.mark.parametrize("case", ["bf16", "int8", "h3"])
def test_spec_ring_rewind_restores_bit_exact(cfgs, case):
    """Total rejection: snapshot -> 4 coarse draft steps (slot 0 crosses the
    ring boundary at 32: at H = 3 its evicted block collapses into level 2)
    -> rewind restores lengths, page table, pyramid, K/V rows, scales and
    the hierarchy bit for bit."""
    _, tcfg = cfgs
    base = tcfg.replace(activ_dtype="bfloat16") if case == "bf16" else tcfg
    tp = init_params(base, seed=0, device="cpu")
    cfg, eng = _park(base, tp, kv_quant=case == "int8",
                     levels=3 if case == "h3" else 2)
    assert eng.kv.lengths.tolist() == [30, 12]
    before = _flat(eng.kv.tree)
    act = torch.tensor([True, True])
    snap = eng.kv.spec_snapshot(5)
    dcfg = draft_config(cfg)
    tok = torch.tensor([7, 9])
    for _ in range(4):
        logits, _ = TT.decode_step(tp, dcfg, eng.kv.tree, tok, active=act)
        tok = torch.argmax(logits[:, :cfg.vocab], -1)
    assert int(eng.kv.lengths[0]) == 34  # the drafts really advanced/evicted
    if case == "h3":
        assert int(eng.kv.tree["hier_cnt2"].sum()) > int(
            before["hier_cnt2"].sum())  # a collapse happened
    eng.kv.spec_rewind(snap, snap["lengths"], act)
    after = _flat(eng.kv.tree)
    assert after.keys() == before.keys()
    for key in before:
        assert torch.equal(after[key], before[key]), key


def test_collect_kv_matches_the_jax_model(cfgs, params):
    """Two ragged chunks through a fresh cache: all-position logits and the
    per-layer fp32 chunk K/V equal the reference's."""
    jcfg, tcfg = cfgs
    jp, tp = params
    model = get_model(jcfg)
    r = np.random.default_rng(0)
    B, C = 3, 5
    jcache = jax_init(model.cache_specs(jcfg, B, 64), jax.random.PRNGKey(1))
    tcache = RingPagedKVCache(tcfg, B, 64, device="cpu").tree
    # the reference under jax.jit, the config closed over
    jprefill = jax.jit(lambda p, c, t, n: model.prefill_chunk(
        p, jcfg, c, t, n, all_logits=True, collect_kv=True))
    for nv in ([5, 3, 0], [2, 5, 4]):
        toks = r.integers(0, tcfg.vocab, (B, C))
        nv = np.asarray(nv, np.int32)
        jl, jcache, (jk, jv) = jprefill(jp, jcache,
                                        jnp.asarray(toks, jnp.int32),
                                        jnp.asarray(nv))
        tl, _, (tk, tv) = TT.prefill_chunk(
            tp, tcfg, tcache, torch.as_tensor(toks), torch.as_tensor(nv),
            all_logits=True, collect_kv=True)
        assert tk.shape == (tcfg.num_layers, B, tcfg.kv_heads, C, tcfg.hd)
        assert tk.dtype == torch.float32
        for got, want in ((tk, jk), (tv, jv), (tl, jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("levels", [2, 3])
def test_split_wave_matches_the_jax_decoder(cfgs, levels):
    jcfg, tcfg = (c.replace(attention=c.attention.replace(levels=levels))
                  for c in cfgs)
    lengths = np.array([0, 12, 47, 48, 49, 61, 63, 64, 66, 79, 80, 95],
                       np.int32)
    B = len(lengths)
    jkv = JRingPagedKVCache(jcfg, get_model(jcfg), B, 64)
    jkv.tree["lengths"] = jnp.asarray(lengths)
    tkv = RingPagedKVCache(tcfg, B, 64, device="cpu")
    tkv.tree["lengths"].copy_(torch.as_tensor(lengths))
    active = np.arange(B) % 5 != 3
    for k in (1, 3, 4):
        want = JSpecDecoder(jcfg, k).split_wave(jkv, active)
        got = SpecDecoder(tcfg, k).split_wave(tkv, active)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_spec_residual_and_greedy_verify_match_jax(seed):
    r = np.random.default_rng(seed)
    B, K, V = 4, 3, 24
    p = r.dirichlet(np.full(V, 0.5), B).astype(np.float32)
    q = r.dirichlet(np.full(V, 0.5), B).astype(np.float32)
    q[0] = p[0]  # empty residual: the guard falls back to log p
    np.testing.assert_allclose(
        tsampling.spec_residual(torch.from_numpy(p), torch.from_numpy(q)).numpy(),
        np.asarray(jsampling.spec_residual(jnp.asarray(p), jnp.asarray(q))),
        rtol=1e-6, atol=1e-6)
    logits = r.standard_normal((B, K + 1, V)).astype(np.float32)
    draft = np.argmax(logits[:, :K], -1).astype(np.int32)
    draft[1, 1] = (draft[1, 1] + 1) % 20  # rejections at varied positions
    draft[2, 0] = (draft[2, 0] + 3) % 20
    active = np.array([True, True, True, False])
    zeros = np.zeros((B,), np.float32)
    args = (zeros, np.zeros((B,), np.int32), np.ones((B,), np.float32),
            np.arange(B, dtype=np.int32), np.full((B,), 5, np.int32))
    want = jsampling.spec_verify_batch(
        jnp.asarray(logits), jnp.asarray(draft), jnp.zeros((B, K, V)),
        *map(jnp.asarray, args), jnp.asarray(active), vocab=20)
    got = tsampling.spec_verify_batch(
        torch.from_numpy(logits), torch.from_numpy(draft),
        torch.zeros((B, K, V)), *args, torch.from_numpy(active), vocab=20)
    _, n_out, n_acc = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[1].numpy(), n_out)
    np.testing.assert_array_equal(got[2].numpy(), n_acc)
    for b in range(B):  # emitted tokens agree where they are read
        np.testing.assert_array_equal(got[0][b, : n_out[b]].numpy(),
                                      np.asarray(want[0])[b, : n_out[b]])


@pytest.mark.parametrize("seed", range(4))
def test_rejection_sampling_emits_the_target_distribution(seed):
    """Accept d ~ q with probability min(1, p(d)/q(d)), resample rejections
    from norm(max(p - q, 0)): the emitted token follows p. Exactly (the
    identity through ``spec_residual``), and empirically through
    ``spec_verify_batch``: Pearson chi-square below the 0.1% critical value
    for 7 degrees of freedom (24.32)."""
    r = np.random.default_rng(seed)
    V, n = 8, 4000
    p_logits = r.standard_normal(V).astype(np.float32)
    q_logits = (1.5 * r.standard_normal(V)).astype(np.float32)
    p = torch.softmax(torch.from_numpy(p_logits), -1).double()
    q = torch.softmax(torch.from_numpy(q_logits), -1).double()
    resid = torch.exp(tsampling.spec_residual(p.float(), q.float())).double()
    emitted = torch.minimum(p, q) + (1 - torch.minimum(p, q).sum()) * (
        resid / resid.sum())
    np.testing.assert_allclose(emitted.numpy(), p.numpy(), atol=1e-6)

    draft = r.choice(V, size=(n, 1), p=q.numpy() / q.numpy().sum())
    logits = torch.from_numpy(np.tile(p_logits, (n, 2, 1)))
    q_probs = torch.from_numpy(np.tile(q.float().numpy(), (n, 1, 1)))
    out, n_out, _ = tsampling.spec_verify_batch(
        logits, torch.from_numpy(draft), q_probs, np.ones(n, np.float32),
        np.zeros(n, np.int64), np.ones(n, np.float32), np.arange(n) % 97,
        np.arange(n) // 97, torch.ones(n, dtype=torch.bool))
    assert bool((n_out >= 1).all())
    counts = np.bincount(out[:, 0].numpy(), minlength=V)
    expect = n * p.numpy()
    chi2 = float((((counts - expect) ** 2) / expect).sum())
    assert chi2 < 24.32, (chi2, counts, expect)


@pytest.mark.parametrize("K,n_match", [(1, 0), (1, 1), (2, 1), (3, 0),
                                       (3, 2), (4, 4)])
def test_greedy_verify_is_an_argmax_prefix_match(K, n_match):
    r = np.random.default_rng(10 * K + n_match)
    V = 16
    logits = torch.from_numpy(r.standard_normal((1, K + 1, V)).astype(np.float32))
    argmax = logits[0].argmax(-1).numpy()
    draft = argmax[:K].copy()
    if n_match < K:
        draft[n_match] = (draft[n_match] + 1) % V
    out, n_out, n_acc = tsampling.spec_verify_batch(
        logits, torch.from_numpy(draft[None]), torch.zeros((1, K, V)),
        [0.0], [0], [1.0], [3], [5], torch.tensor([True]))
    assert int(n_acc[0]) == n_match and int(n_out[0]) == n_match + 1
    np.testing.assert_array_equal(out[0, : n_match + 1].numpy(),
                                  argmax[: n_match + 1])


@pytest.mark.parametrize("seed", range(3))
def test_draft_equal_to_target_accepts_everything(seed):
    """q == p makes min(1, p/q) = 1: every draft is accepted."""
    r = np.random.default_rng(seed)
    K, V = 4, 16
    logits = torch.from_numpy(r.standard_normal((1, K + 1, V)).astype(np.float32))
    args = ([0.8], [0], [1.0])
    q = torch.stack([torch.softmax(tsampling.filtered_logits(
        logits[:, i], *args), -1) for i in range(K)], 1)
    draft = q.argmax(-1)
    _, n_out, n_acc = tsampling.spec_verify_batch(
        logits, draft, q, *args, [seed % 997], [2], torch.tensor([True]))
    assert int(n_acc[0]) == K and int(n_out[0]) == K + 1


def _sampled():
    return [Request(prompt=np.arange(1, 20), max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.9, seed=7)),
            Request(prompt=np.array([5, 11, 2]), max_new_tokens=8,
                    sampling=SamplingParams(temperature=1.0, top_k=5, seed=3)),
            Request(prompt=np.arange(2, 12), max_new_tokens=5,
                    sampling=SamplingParams(temperature=0.7, top_p=0.9,
                                            seed=11)),
            Request(prompt=np.arange(4, 9), max_new_tokens=7)]


def test_sampled_spec_batched_equals_solo_and_is_deterministic(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    ecfg = EngineConfig(slots=3, max_len=64, chunk=8, spec_k=3)
    runs = [Engine(tcfg, tp, ecfg, device="cpu").run(_sampled())
            for _ in range(2)]
    by = [{len(r.prompt): r for r in run} for run in runs]
    for plen, r in by[0].items():
        np.testing.assert_array_equal(r.out, by[1][plen].out)
        assert r.spec_accepted == by[1][plen].spec_accepted
        assert len(r.out) == r.max_new_tokens
    for req in _sampled():
        solo = Engine(tcfg, tp, ecfg, device="cpu").run([req])[0]
        np.testing.assert_array_equal(solo.out, by[0][len(req.prompt)].out)
        assert solo.spec_accepted == by[0][len(req.prompt)].spec_accepted


def test_h3_speculative_matches_plain_and_the_jax_engine(cfgs, params):
    """Greedy speculative serving at levels=3 — prompts far past the
    64-token window, generation across block boundaries, so rounds start on
    a boundary and the trim rewind replays a collapse — emits plain
    decoding's tokens and the reference engine's, with its counters."""
    jcfg, tcfg = (c.replace(attention=c.attention.replace(levels=3))
                  for c in cfgs)
    jp, tp = params
    mix = [(np.arange(1, 201) % 512, 40), (np.arange(3, 40), 24),
           (np.arange(5, 150), 30)]
    ecfg = EngineConfig(slots=2, max_len=64, chunk=32)
    plain = _run(Engine, Request, Engine(tcfg, tp, ecfg, device="cpu"), mix)
    jeng = JEngine(jcfg, jp, JEngineConfig(slots=2, max_len=64, chunk=32,
                                           spec_k=3))
    ref = _run(JEngine, JRequest, jeng, mix)
    eng = Engine(tcfg, tp, ecfg.replace(spec_k=3), device="cpu")
    got = _run(Engine, Request, eng, mix)
    for plen in ref:
        np.testing.assert_array_equal(got[plen], plain[plen])
        np.testing.assert_array_equal(got[plen], ref[plen])
    for key in SPEC_COUNTERS:
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["spec_rounds"] > 0
    assert eng.kv.occupancy() == jeng.kv.occupancy()


@pytest.mark.parametrize("nsplit", [1, 2, 4])
def test_budget_one_split_equals_unsplit(nsplit):
    """The drafts' budget m = 1 (own block only) under split decode: splits
    whose range holds no selected page add nothing to the merge."""
    r = np.random.default_rng(nsplit)
    B, Hkv, G, D, b, nb = 2, 2, 2, 16, 16, 4
    S = nb * b
    from repro_torch.core import mra_decode as tmd
    from repro_torch.core.mra import MraConfig

    k = torch.from_numpy(r.standard_normal((B, Hkv, S, D)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((B, Hkv, S, D)).astype(np.float32))
    q = torch.from_numpy(r.standard_normal((B, Hkv * G, 1, D)).astype(np.float32))
    lengths = torch.tensor([S, 37], dtype=torch.int32)
    pb = tmd.identity_page_table(B, nb)
    mask = tmd.paged_position_mask(lengths, pb, S, b).float()[:, None, :, None]
    pyr = tmd.PyramidState((k * mask).reshape(B, Hkv, nb, b, D).sum(3),
                           (v * mask).reshape(B, Hkv, nb, b, D).sum(3))
    q_pos = (lengths - 1)[:, None]
    pre = tmd._chunk_prelude(q, k, v, lengths, q_pos, MraConfig(block_size=b),
                             1, pyr, pb)
    ref = chunk_attn.chunk_attention_ref(pre, k, v, q_pos, m=1)
    got = chunk_attn.chunk_attention_split_ref(pre, k, v, q_pos, m=1,
                                               nsplit=nsplit)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-6, rtol=1e-5)


def test_unservable_speculation_raises(cfgs, params):
    _, tcfg = cfgs
    _, tp = params
    dense = tcfg.replace(attention=tcfg.attention.replace(kind="full"))
    with pytest.raises(NotImplementedError, match="coarse"):
        Engine(dense, tp, ECFG.replace(spec_k=2), device="cpu")
    with pytest.raises(NotImplementedError, match="draft_level"):
        Engine(tcfg, tp, ECFG.replace(spec_k=2, draft_level=2), device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        Engine(tcfg, tp, ECFG.replace(spec_k=64), device="cpu")
    # the non-paged cache has no snapshot to take
    with pytest.raises(NotImplementedError, match="ring-paged"):
        RingPagedKVCache(dense, 1, 32, device="cpu").spec_snapshot(3)


def test_int8_window_snapshot_holds_scales(cfgs):
    """The int8 cache's snapshot carries the window's per-token scales."""
    _, tcfg = cfgs
    cfg = tcfg.replace(attention=tcfg.attention.replace(kv_quant=True))
    kv = RingPagedKVCache(cfg, 2, 32, device="cpu")
    snap = kv.spec_snapshot(4)
    assert set(snap["win"]) == {"k", "v", "k_scale", "v_scale"}
    assert snap["win"]["k_scale"][0].shape == (2, 4, cfg.kv_heads)
    assert snap["win"]["k"][0].dtype == torch.int8


def test_any_sampling_matches_the_jax_scheduler():
    """Only DECODE slots count by default; a sampling request still
    prefilling does not send greedy decode slots down the sampling path."""
    from repro.serve import SamplingParams as JSamplingParams
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve import Scheduler

    def drive(sched_cls, req_cls, sp_cls):
        sched = sched_cls(3, 64, 4)
        for n, t in ((2, 0.0), (9, 0.8), (3, 0.0)):
            sched.submit(req_cls(prompt=np.arange(1, n + 1), max_new_tokens=4,
                                 sampling=sp_cls(temperature=t, seed=1)))
        sched.admit()
        seen = [sched.any_sampling()]
        sched.prefill_plan()  # slots 0 and 2 finish their prompts
        seen += [sched.any_sampling(), sched.any_sampling([1]),
                 sched.any_sampling([0, 2])]
        sched.prefill_plan()
        sched.prefill_plan()  # slot 1's 9-token prompt completes
        seen.append(sched.any_sampling())
        return seen

    got = drive(Scheduler, Request, SamplingParams)
    assert got == drive(JScheduler, JRequest, JSamplingParams)
    assert got == [False, False, True, False, True]
