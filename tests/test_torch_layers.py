"""Port parity: repro_torch.models.layers vs repro.models.layers at fp32.

Same numpy inputs and weights through both; outputs agree at 1e-6 (fp32
arithmetic in a different operation order). RoPE is checked at ``(S,)``
and per-batch ``(B, S)`` positions; embed/unembed with a padded vocab.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as TL

TOL = dict(atol=1e-6, rtol=1e-6)


def T(x):
    return torch.from_numpy(np.array(x))


def _rand(r, *shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


def _cfgs(**kw):
    kw.setdefault("activ_dtype", "float32")
    return jax_smoke("qwen3-1.7b", **kw), get_smoke_config("qwen3-1.7b", **kw)


@pytest.mark.parametrize("shape", [(5, 64), (2, 3, 7, 16)])
def test_rms_norm_matches_jax(shape):
    r = np.random.default_rng(0)
    x, w = _rand(r, *shape), _rand(r, shape[-1])
    np.testing.assert_allclose(TL.rms_norm(T(x), T(w), 1e-6).numpy(),
                               np.asarray(JL.rms_norm(jnp.asarray(x),
                                                      jnp.asarray(w), 1e-6)),
                               **TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_jax(batched):
    r = np.random.default_rng(1)
    B, H, S, hd = 2, 3, 9, 16
    x = _rand(r, B, H, S, hd)
    pos = (r.integers(0, 200, (B, S)) if batched else np.arange(S) + 40
           ).astype(np.int32)
    got = TL.apply_rope(T(x), T(pos), 1e6).numpy()
    ref = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(TL.rope_freqs(hd, 1e6).numpy(),
                               np.asarray(JL.rope_freqs(hd, 1e6)), **TOL)


@pytest.mark.parametrize("qk_norm,qkv_bias", [(True, False), (False, False),
                                               (False, True), (True, True)])
def test_qkv_project_matches_jax(qk_norm, qkv_bias):
    jcfg, tcfg = _cfgs(qk_norm=qk_norm, qkv_bias=qkv_bias)
    r = np.random.default_rng(2)
    d, H, Hkv, hd = jcfg.d_model, jcfg.num_heads, jcfg.kv_heads, jcfg.hd
    p = {"wq": _rand(r, d, H, hd, scale=0.1), "wk": _rand(r, d, Hkv, hd, scale=0.1),
         "wv": _rand(r, d, Hkv, hd, scale=0.1), "wo": _rand(r, H, hd, d)}
    if qkv_bias:
        p.update(bq=_rand(r, H, hd), bk=_rand(r, Hkv, hd), bv=_rand(r, Hkv, hd))
    if qk_norm:
        p.update(qnorm=_rand(r, hd), knorm=_rand(r, hd))
    x = _rand(r, 2, 5, d)
    pos = (np.arange(5)[None] + np.array([[3], [60]])).astype(np.int32)
    got = TL.qkv_project(T(x), {k: T(v) for k, v in p.items()}, tcfg, T(pos))
    ref = JL.qkv_project(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                         jcfg, jnp.asarray(pos))
    for g, rf in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rf), **TOL)


def test_mlp_block_matches_jax():
    jcfg, tcfg = _cfgs()
    r = np.random.default_rng(3)
    d, f = jcfg.d_model, jcfg.d_ff
    p = {"wi": _rand(r, d, f, scale=0.1), "wg": _rand(r, d, f, scale=0.1),
         "wo": _rand(r, f, d, scale=0.1)}
    x = _rand(r, 2, 4, d)
    got = TL.mlp_block(T(x), {k: T(v) for k, v in p.items()}, tcfg).numpy()
    ref = np.asarray(JL.mlp_block(jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in p.items()},
                                  jcfg))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_unembed_padded_vocab_match_jax(tie):
    jcfg, tcfg = _cfgs(vocab=500, tie_embeddings=tie)
    assert tcfg.padded_vocab == jcfg.padded_vocab == 512
    r = np.random.default_rng(4)
    p = {"tok": _rand(r, 512, jcfg.d_model, scale=0.02)}
    if not tie:
        p["head"] = _rand(r, jcfg.d_model, 512, scale=0.1)
    tokens = r.integers(0, 500, (2, 6)).astype(np.int32)
    tp = {k: T(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = TL.embed(T(tokens).long(), tp, tcfg)
    np.testing.assert_array_equal(x.numpy(), np.asarray(
        JL.embed(jnp.asarray(tokens), jp, jcfg)))
    np.testing.assert_allclose(TL.unembed(x, tp, tcfg).numpy(),
                               np.asarray(JL.unembed(jnp.asarray(x.numpy()), jp,
                                                     jcfg)), **TOL)


def test_head_mask_matches_jax():
    jcfg, tcfg = _cfgs(num_heads=6, kv_heads=2, pad_attn_heads_to=4)
    assert tcfg.padded_heads == jcfg.padded_heads == 8
    np.testing.assert_array_equal(TL.head_mask(tcfg).numpy(),
                                  np.asarray(JL.head_mask(jcfg)))


def test_bf16_activations_stay_bf16():
    _, tcfg = _cfgs(activ_dtype="bfloat16")
    r = np.random.default_rng(5)
    x = T(_rand(r, 2, 3, 64)).to(torch.bfloat16)
    w = T(_rand(r, 64))  # fp32 norm weight, cast to fp32 at use
    assert TL.rms_norm(x, w).dtype == torch.bfloat16
    p = {"wi": T(_rand(r, 64, 128)), "wg": T(_rand(r, 64, 128)),
         "wo": T(_rand(r, 128, 64))}
    assert TL.mlp_block(x, p, tcfg).dtype == torch.bfloat16
