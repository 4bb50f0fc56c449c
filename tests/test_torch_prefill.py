"""Port parity: the whole-prompt ``prefill`` and the configs that need it.

``repro_torch.models.transformer.prefill`` against the reference's
``repro.models.transformer.prefill`` on the CPU at fp32 activations, with
the reference's weights carried over by ``params_from_jax``, for the
qwen3-1.7b, qwen2-7b (qkv bias), yi-6b and granite-moe smoke configs, with
the activation-dtype (fp32) cache and with the int8 cache. Tolerances
(``test_torch_transformer``'s rules): last logits atol 1e-4; K/V,
pyramid sums and int8 scales within 1e-5 normwise (every entry within
1e-5 of the tensor's largest magnitude); int8 codes within one step (a
rounding boundary); page tables and lengths exactly.

The port's ``prefill`` cache also equals the port's ``prefill_chunk`` cache
over the same prompt when both attentions are exact (a budget that covers
the prompt: MRA-2 selects every causal block, the chunk kernel every page),
at the same tolerances; with an int8 cache the whole-prompt pass attends
unrounded K/V, so there only layer 0 (whose K/V do not depend on
attention) is held. And the four configs' ``CONFIG`` / ``smoke()`` equal
the reference's field for field, and the full configs' ``param_specs``
build with the reference's shapes.
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
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.models import transformer as JT
from repro.models.params import count_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.models.params import (
    TensorSpec,
    init_params,
    param_specs,
    params_from_jax,
)
from repro_torch.serve.cache import RingPagedKVCache
from test_torch_transformer import _cache_close

ARCHS = ["qwen3-1.7b", "qwen2-7b", "yi-6b", "granite-moe-3b-a800m"]
NEW_ARCHS = ["qwen2-7b", "yi-6b", "granite-moe-3b-a800m", "kimi-k2-1t-a32b"]
B, MAX_LEN, S = 2, 64, 48  # a 48-token prompt: three 16-token pages of four


def _configs(arch, quant=False, **attention):
    jcfg = jax_smoke(arch, activ_dtype="float32")
    tcfg = get_smoke_config(arch, activ_dtype="float32")
    attention["kv_quant"] = quant
    return (jcfg.replace(attention=dataclasses.replace(jcfg.attention,
                                                       **attention)),
            tcfg.replace(attention=tcfg.attention.replace(**attention)))


def _params(jcfg, tcfg, seed=0):
    jp = jax_init(jax_get_model(jcfg).param_specs(jcfg),
                  jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.device_get(jp), tcfg, device="cpu")


def _jprefill(jcfg):
    """The reference's ``prefill`` under ``jax.jit``, the config closed
    over (op-by-op dispatch took most of these tests' time)."""
    return jax.jit(lambda p, b, c: JT.prefill(p, jcfg, b, c))


def _prompt(vocab, seed=0, n=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, n))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, quant):
    jcfg, tcfg = _configs(arch, quant)
    jp, tp = _params(jcfg, tcfg)
    toks = _prompt(jcfg.vocab)
    jc = jax_init(JT.cache_specs(jcfg, B, MAX_LEN), jax.random.PRNGKey(1))
    jl, jc = _jprefill(jcfg)(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             jc)
    tc = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    tl, tc2 = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)}, tc)
    assert tc2 is tc  # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _cache_close(tc, jc, quant)
    assert tc["lengths"].tolist() == [S] * B
    assert tc["page_blocks"][0].tolist() == [0, 1, 2, -1]


def _chunked(tcfg, tp, toks, C=16):
    tc = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    nv = torch.full((B,), C, dtype=torch.int32)
    for c0 in range(0, toks.shape[1], C):
        logits, tc = TT.prefill_chunk(tp, tcfg, tc,
                                      torch.as_tensor(toks[:, c0:c0 + C]), nv)
    return logits, tc


def _caches_close(a, b, layers):
    for key in ("k", "v", "k_scale", "v_scale", "pyr_k", "pyr_v"):
        for i in range(layers if key in a else 0):
            x, y = a[key][i], b[key][i]
            if x.dtype == torch.int8:
                assert int((x.int() - y.int()).abs().max()) <= 1, (key, i)
            else:
                tol = 1e-5 * max(1.0, float(y.abs().max()))
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=tol,
                                           rtol=0, err_msg=f"{key}[{i}]")
    assert torch.equal(a["page_blocks"], b["page_blocks"])
    assert torch.equal(a["lengths"], b["lengths"])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_prefill_cache_equals_prefill_chunk(arch, quant):
    _, tcfg = _configs(arch, quant, blocks_per_row=4, decode_blocks=4)
    tp = init_params(tcfg, seed=3, device="cpu")
    toks = _prompt(tcfg.vocab, seed=4)
    whole = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    lw, whole = TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)}, whole)
    lc, chunked = _chunked(tcfg, tp, toks)
    _caches_close(whole, chunked, 1 if quant else tcfg.num_layers)
    if not quant:
        np.testing.assert_allclose(lw.numpy(), lc.numpy(), atol=1e-4)


def test_prefill_then_decode_matches_jax():
    """Decode steps continue from a whole-prompt prefill as they do in the
    reference (the cache it leaves is the one decode reads)."""
    jcfg, tcfg = _configs("granite-moe-3b-a800m")
    jp, tp = _params(jcfg, tcfg)
    toks = _prompt(jcfg.vocab, seed=5)
    jc = jax_init(JT.cache_specs(jcfg, B, MAX_LEN), jax.random.PRNGKey(1))
    _, jc = _jprefill(jcfg)(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    jdecode = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c, t))
    tc = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    TT.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)}, tc)
    for step in range(20):  # past the 64-token ring
        tok = np.array([step + 1, 2 * step + 3])
        jl, jc = jdecode(jp, jc, jnp.asarray(tok, jnp.int32))
        tl, tc = TT.decode_step(tp, tcfg, tc, torch.as_tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=f"step {step}")
    _cache_close(tc, jc, False)


def test_prefill_refuses_a_long_or_unaligned_prompt():
    _, tcfg = _configs("qwen3-1.7b")
    tp = init_params(tcfg, seed=0, device="cpu")
    tc = RingPagedKVCache(tcfg, B, MAX_LEN, device="cpu").tree
    with pytest.raises(ValueError, match="exceeds the cache window"):
        TT.prefill(tp, tcfg, {"tokens": torch.zeros((B, 80), dtype=torch.long)},
                   tc)
    with pytest.raises(ValueError, match="multiple of the block size"):
        TT.prefill(tp, tcfg, {"tokens": torch.zeros((B, 40), dtype=torch.long)},
                   tc)
    assert tc["lengths"].tolist() == [0, 0]  # nothing was written


# --------------------------------------------------------------------------- #
# the configs
# --------------------------------------------------------------------------- #
def _fields_match(tcfg, jcfg):
    """Every field of the port's config equals the reference's (nested specs
    field by field), and every reference field the port lacks is at its
    default, so the port reads all the config sets."""
    for f in dataclasses.fields(tcfg):
        t, j = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(t):
            for g in dataclasses.fields(t):
                assert getattr(t, g.name) == getattr(j, g.name), (f.name, g.name)
        else:
            assert t == j, f.name
    ported = {f.name for f in dataclasses.fields(tcfg)}
    defaults = type(jcfg)(name="x", family="dense", num_layers=1, d_model=1,
                          num_heads=1, kv_heads=1, d_ff=1, vocab=1)
    for f in dataclasses.fields(jcfg):
        if f.name not in ported:
            assert getattr(jcfg, f.name) == getattr(defaults, f.name), f.name


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_the_reference(arch):
    _fields_match(get_config(arch), jax_config(arch))
    _fields_match(get_smoke_config(arch), jax_smoke(arch))


def _spec_leaves(tree, path=()):
    """(path, TensorSpec) pairs of a spec tree (a TensorSpec is a leaf)."""
    if isinstance(tree, TensorSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_config_param_specs_build(arch):
    """The full configs' parameter trees build (no allocation) with the
    reference's shapes and count; kimi-k2 is about 1 T parameters."""
    tcfg, jcfg = get_config(arch), jax_config(arch)
    tspecs = param_specs(tcfg)
    jspecs = jax_get_model(jcfg).param_specs(jcfg)
    n = sum(math.prod(s.shape) for _, s in _spec_leaves(tspecs))
    assert n == count_params(jspecs) and n > 1e8
    if arch == "kimi-k2-1t-a32b":
        assert n > 0.9e12
    layer0 = dict(_spec_leaves(tspecs["layers"][0]))
    jl = jspecs["layers"]  # stacked (L, ...) under scan_layers
    for path, spec in layer0.items():
        leaf = jl
        for key in path:
            leaf = leaf[key]
        assert tuple(leaf.shape[1:]) == spec.shape, path
    assert ("moe" in tspecs["layers"][0]) == (tcfg.family == "moe")
