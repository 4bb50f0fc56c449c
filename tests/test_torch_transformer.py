"""Port parity: repro_torch.models.transformer vs repro.models.transformer.

The qwen3-1.7b and llama3.2-3b smoke configs at fp32 activations, with the
reference's weights carried over by ``params_from_jax``, run the same
sequence of ragged ``prefill_chunk`` calls and ``decode_step``s past the
ring capacity (eviction) through both packages. Tolerances: logits atol
1e-4 (the reference's exact-oracle tolerance: a two-layer model in fp32
with sums in other orders); cache tensors k, v, pyr_k, pyr_v at 1e-5
normwise (every entry within 1e-5 of the tensor's largest magnitude: a
cache entry's rounding error scales with the activations that produced
it); page tables and lengths exactly; int8 cache codes within one step (a
rounding boundary). Frozen slots must stay bit-identical in the port.

At ``levels = 3`` (the collapse-up hierarchy) the same rules hold, and the
shared hierarchy tables (``hier_own*``, ``hier_cnt*``, ``tail_cnt``) must
be exactly equal; the collapsed payloads follow the cache rules above
(fp32 scales and tail sums normwise, int8 means within one step).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model, init_params as jax_init
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.serve.cache import RingPagedKVCache

B, MAX_LEN, C = 3, 32, 8  # two pages of 16: decode wraps the ring


def _configs(arch, **kw):
    kw.setdefault("activ_dtype", "float32")
    jcfg = jax_smoke(arch, **kw)
    tcfg = get_smoke_config(arch, **kw)
    return jcfg, tcfg


def _with_quant(jcfg, tcfg):
    return (jcfg.replace(attention=dataclasses.replace(jcfg.attention,
                                                       kv_quant=True)),
            tcfg.replace(attention=dataclasses.replace(tcfg.attention,
                                                       kv_quant=True)))


def _jax_fns(jcfg):
    """The reference's prefill_chunk / decode_step, jitted like its engine."""
    def pre(p, c, t, n, all_logits=False):
        return JT.prefill_chunk(p, jcfg, c, t, n, all_logits=all_logits)

    def dec(p, c, t, a):
        return JT.decode_step(p, jcfg, c, t, active=a)

    return (jax.jit(pre, static_argnames="all_logits"), jax.jit(dec))


def _setup(jcfg, tcfg, seed=0):
    jparams = jax_init(get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.device_get(jparams), tcfg, device="cpu")
    jcache = jax_init(JT.cache_specs(jcfg, B, MAX_LEN), jax.random.PRNGKey(1))
    tcache = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    return jparams, tparams, jcache, tcache


def _schedule(vocab, seed=0):
    """(kind, tokens, num_valid | active) steps: ragged chunks, a frozen
    slot, then decode waves past the 32-token ring (slot 0 reaches 45)."""
    r = np.random.default_rng(seed)
    steps = [("prefill", r.integers(0, vocab, (B, C)), np.array([8, 5, 0])),
             ("prefill", r.integers(0, vocab, (B, C)), np.array([5, 0, 3])),
             ("prefill", r.integers(0, vocab, (B, C)), np.array([0, 0, 8]))]
    for i in range(32):
        active = np.array([True, i % 3 != 1, i >= 4])
        steps.append(("decode", r.integers(0, vocab, (B,)), active))
    return steps


def _cache_close(tc, jc, quant):
    assert set(tc) == set(jc)
    lists = [k for k in jc if isinstance(jc[k], list)]
    for key in set(jc) - set(lists):  # lengths, page table, hier tables
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=key)
    for key in lists:
        for i, (t, j) in enumerate(zip(tc[key], jc[key])):
            j = np.asarray(j)
            if j.dtype == np.int8:  # codes: a value on a rounding boundary
                np.testing.assert_allclose(t.numpy().astype(np.int32),
                                           j.astype(np.int32), atol=1,
                                           err_msg=f"{key}[{i}]")
            else:
                scale = max(1.0, float(np.abs(j).max()))
                np.testing.assert_allclose(t.numpy(), j, atol=1e-5 * scale,
                                           rtol=0, err_msg=f"{key}[{i}]")


def _frozen_rows(tc, slot):
    return {k: ([a[slot].clone() for a in v] if isinstance(v, list)
                else v[slot].clone()) for k, v in tc.items()}


def _assert_rows_equal(tc, before, slot):
    for k, v in before.items():
        now = tc[k]
        pairs = zip(now, v) if isinstance(v, list) else [(now, v)]
        for a, b in pairs:
            assert torch.equal(a[slot], b), f"frozen slot {slot} changed {k}"


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama3.2-3b"])
@pytest.mark.parametrize("quant", [False, True])
def test_prefill_and_decode_match_jax(arch, quant):
    jcfg, tcfg = _configs(arch)
    if quant:
        jcfg, tcfg = _with_quant(jcfg, tcfg)
    jparams, tparams, jc, tc = _setup(jcfg, tcfg)
    jpre, jdec = _jax_fns(jcfg)
    for n, (kind, toks, arg) in enumerate(_schedule(jcfg.vocab)):
        frozen = np.flatnonzero(arg == 0) if kind == "prefill" else \
            np.flatnonzero(~arg)
        before = {s: _frozen_rows(tc, s) for s in frozen}
        if kind == "prefill":
            jl, jc = jpre(jparams, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg, jnp.int32))
            tl, tc = TT.prefill_chunk(tparams, tcfg, tc, torch.as_tensor(toks),
                                      torch.as_tensor(arg, dtype=torch.int32))
            live = arg > 0
        else:
            jl, jc = jdec(jparams, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg))
            tl, tc = TT.decode_step(tparams, tcfg, tc, torch.as_tensor(toks),
                                    active=torch.as_tensor(arg))
            live = arg
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, err_msg=f"step {n} ({kind})")
        _cache_close(tc, jc, quant)
        for s, rows in before.items():
            _assert_rows_equal(tc, rows, s)
    assert int(tc["lengths"][0]) > MAX_LEN  # the ring wrapped


def _with_levels(jcfg, tcfg, levels, hier_pages=0):
    return tuple(c.replace(attention=dataclasses.replace(
        c.attention, levels=levels, hier_pages=hier_pages))
        for c in (jcfg, tcfg))


def _hier_schedule(vocab, seed=0):
    """Ragged chunks with a frozen slot far past the 32-token window, then
    decode waves: slot 0 reaches 8 x 8 + 40 = 104 tokens, so evicted pages
    fill level 2 and cascade into the tail."""
    r = np.random.default_rng(seed)
    valid = [[8, 5, 0], [8, 0, 3], [8, 8, 8], [8, 3, 0], [8, 8, 5],
             [8, 0, 8], [8, 8, 8], [8, 1, 8]]
    steps = [("prefill", r.integers(0, vocab, (B, C)), np.array(nv))
             for nv in valid]
    for i in range(40):
        steps.append(("decode", r.integers(0, vocab, (B,)),
                      np.array([True, i % 3 != 1, i >= 4])))
    return steps


def _run_schedule(jcfg, tcfg, steps, quant):
    jparams, tparams, jc, tc = _setup(jcfg, tcfg)
    jpre, jdec = _jax_fns(jcfg)
    for n, (kind, toks, arg) in enumerate(steps):
        frozen = np.flatnonzero(arg == 0) if kind == "prefill" else \
            np.flatnonzero(~arg)
        before = {s: _frozen_rows(tc, s) for s in frozen}
        if kind == "prefill":
            jl, jc = jpre(jparams, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg, jnp.int32))
            tl, tc = TT.prefill_chunk(tparams, tcfg, tc, torch.as_tensor(toks),
                                      torch.as_tensor(arg, dtype=torch.int32))
            live = arg > 0
        else:
            jl, jc = jdec(jparams, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg))
            tl, tc = TT.decode_step(tparams, tcfg, tc, torch.as_tensor(toks),
                                    active=torch.as_tensor(arg))
            live = arg
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, err_msg=f"step {n} ({kind})")
        _cache_close(tc, jc, quant)
        for s, rows in before.items():
            _assert_rows_equal(tc, rows, s)
    return tc


@pytest.mark.parametrize("arch,levels,hier_pages", [
    ("qwen3-1.7b", 3, 0), ("qwen3-1.7b", 5, 1), ("llama3.2-3b", 4, 1)])
def test_hier_prefill_and_decode_match_jax(arch, levels, hier_pages):
    """H >= 3: ragged chunks and decode waves far past the window give the
    reference's logits and caches, the shared hierarchy tables exactly.

    The KV cache is fp32 here: with an int8 KV cache a token's code can
    land one step apart in the two frameworks (a rounding boundary), which
    moves the logits by ~1e-3 whatever the hierarchy does; the collapsed
    levels are int8 either way, and int8 KV caches under the fold are held
    at the attention level (tests/test_torch_hier.py)."""
    jcfg, tcfg = _with_levels(*_configs(arch), levels, hier_pages)
    tc = _run_schedule(jcfg, tcfg, _hier_schedule(jcfg.vocab), False)
    assert int(tc["lengths"][0]) == 104
    cnt = [int(tc[f"hier_cnt{l}"][0].sum()) for l in range(2, levels)]
    tail = int(tc["tail_cnt"][0])
    assert cnt[0] > 0 and sum(cnt[1:]) + tail > 0  # cascades past level 2
    # every token of slot 0 is live, collapsed or in the tail, exactly once
    live = int(tc["lengths"][0]) - int(tc["page_blocks"][0].min()) * 16
    assert live + sum(cnt) + tail == int(tc["lengths"][0])


def test_hier_cache_specs_match_jax():
    jcfg, tcfg = _with_levels(*_configs("qwen3-1.7b"), 4, 3)
    jspec = JT.cache_specs(jcfg, B, MAX_LEN)
    tspec = TT.cache_specs(tcfg, B, MAX_LEN)
    assert set(jspec) == set(tspec)
    assert {"hier_k3", "hier_own2", "tail_k", "tail_cnt"} <= set(tspec)
    for key, js in jspec.items():
        ts = tspec[key]
        pairs = zip(js, ts) if isinstance(js, list) else [(js, ts)]
        for j, t in pairs:
            assert tuple(j.shape) == tuple(t.shape), key
            assert np.dtype(j.dtype).name == str(t.dtype).replace(
                "torch.", ""), key
            fill = j.scale if j.init == "fill" else None
            assert t.init == j.init and (fill is None or t.fill == fill), key
    two = TT.cache_specs(_configs("qwen3-1.7b")[1], B, MAX_LEN)
    assert not any(k.startswith(("hier", "tail")) for k in two)


def test_all_logits_chunk_matches_jax():
    jcfg, tcfg = _configs("qwen3-1.7b")
    jparams, tparams, jc, tc = _setup(jcfg, tcfg)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (B, C))
    nv = np.array([8, 3, 6])
    jpre, _ = _jax_fns(jcfg)
    jl, _ = jpre(jparams, jc, jnp.asarray(toks, jnp.int32),
                 jnp.asarray(nv, jnp.int32), all_logits=True)
    tl, _ = TT.prefill_chunk(tparams, tcfg, tc, torch.as_tensor(toks),
                             torch.as_tensor(nv, dtype=torch.int32),
                             all_logits=True)
    for b in range(B):  # valid positions only (padding lanes are garbage)
        np.testing.assert_allclose(tl.numpy()[b, :nv[b]],
                                   np.asarray(jl)[b, :nv[b]], atol=1e-4)


def test_params_from_jax_takes_a_stacked_tree():
    """scan_layers=True trees hold (L, ...) stacked leaves; the conversion
    unstacks them into the same per-layer tensors, and the model then
    computes the reference's logits."""
    jcfg, tcfg = _configs("qwen3-1.7b", scan_layers=True)
    stacked = jax.device_get(jax_init(get_model(jcfg).param_specs(jcfg),
                                      jax.random.PRNGKey(0)))
    assert isinstance(stacked["layers"], dict)
    tparams = params_from_jax(stacked, tcfg, device="cpu")
    for i in range(tcfg.num_layers):
        np.testing.assert_array_equal(tparams["layers"][i]["attn"]["wq"].numpy(),
                                      stacked["layers"]["attn"]["wq"][i])
    jc = jax_init(JT.cache_specs(jcfg, B, MAX_LEN), jax.random.PRNGKey(1))
    tc = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (B, C))
    nv = np.array([8, 8, 2])
    jpre, _ = _jax_fns(jcfg)
    jl, _ = jpre(stacked, jc, jnp.asarray(toks, jnp.int32),
                 jnp.asarray(nv, jnp.int32))
    tl, _ = TT.prefill_chunk(tparams, tcfg, tc, torch.as_tensor(toks),
                             torch.as_tensor(nv, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_bf16_smoke_run_close_to_jax():
    """bf16 activations round at other places in the two frameworks; the
    logits stay within 0.1 absolute (logits here are O(1)), and the two
    packages pick the same argmax for at least 90% of the rows."""
    jcfg, tcfg = _configs("qwen3-1.7b", activ_dtype="bfloat16")
    jparams, tparams, jc, tc = _setup(jcfg, tcfg)
    jpre, jdec = _jax_fns(jcfg)
    agree = total = 0
    worst = 0.0
    for kind, toks, arg in _schedule(jcfg.vocab, seed=1)[:12]:
        if kind == "prefill":
            jl, jc = jpre(jparams, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg, jnp.int32))
            tl, tc = TT.prefill_chunk(tparams, tcfg, tc, torch.as_tensor(toks),
                                      torch.as_tensor(arg, dtype=torch.int32))
            live = arg > 0
        else:
            jl, jc = jdec(jparams, jc, jnp.asarray(toks, jnp.int32),
                          jnp.asarray(arg))
            tl, tc = TT.decode_step(tparams, tcfg, tc, torch.as_tensor(toks),
                                    active=torch.as_tensor(arg))
            live = arg
        t = tl.float().numpy()[live]
        j = np.asarray(jl.astype(jnp.float32))[live]
        worst = max(worst, float(np.abs(t - j).max()))
        agree += int((t.argmax(-1) == j.argmax(-1)).sum())
        total += len(t)
    assert tl.dtype == torch.bfloat16
    assert worst < 0.1, worst
    assert agree >= 0.9 * total, (agree, total)


def test_init_params_is_seeded_and_typed():
    _, tcfg = _configs("qwen3-1.7b", param_dtype="bfloat16")
    a = init_params(tcfg, seed=3, device="cpu")
    b = init_params(tcfg, seed=3, device="cpu")
    c = init_params(tcfg, seed=4, device="cpu")
    wq = a["layers"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    assert a["layers"][0]["ln1"]["w"].dtype == torch.float32  # norms stay fp32
    assert torch.equal(wq, b["layers"][0]["attn"]["wq"])
    assert not torch.equal(wq, c["layers"][0]["attn"]["wq"])
    # truncated normal at fan-in std: |w| <= 2 / sqrt(fan_in), fan-in = H
    assert float(wq.float().abs().max()) <= 2.0 / np.sqrt(tcfg.num_heads) + 1e-2
    assert float(a["embed"]["tok"].float().std()) == pytest.approx(0.02, rel=0.1)


def test_entry_points_need_cuda_or_an_explicit_cpu():
    _, tcfg = _configs("qwen3-1.7b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tcfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RingPagedKVCache(tcfg, 2, 32)
