"""Port parity: the paper's baselines (repro_torch.core.baselines) vs the
JAX package.

On the same numpy inputs, on the CPU:

  * each of the six baselines (Linformer, Performer, Nyströmformer,
    Longformer, BigBird, H-Transformer-1D) and ``full`` against the
    reference's function within 1e-5 (atol and rtol), with the reference's
    random draws computed here in JAX and passed in (Linformer's ``E``,
    Performer's ``W``, BigBird's ``rand_idx``): the port cannot draw with
    ``jax.random``. The three that draw nothing match on the inputs alone;
    non-default options (Longformer's global tokens, other seeds and
    sizes) too;
  * ``self_attention`` routes every ``REGISTRY`` key as the reference's
    does, with GQA (G = 2: the KV heads repeated) and with the default
    draws replaced by the reference's;
  * the port's own default draws: fixed by the seed, on the CPU generator
    whatever the device (orthogonal feature blocks, chi-distributed norms,
    block ids in range); the baselines' serving kinds attend exactly.
"""
from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.core import baselines as JB
from repro_torch.core import attention as TA
from repro_torch.core import baselines as TB

TOL = 1e-5


def _qkv(seed, B=2, H=2, N=128, D=16, Hkv=None):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, N, D)).astype(np.float32)
    kv = [r.standard_normal((B, Hkv or H, N, D)).astype(np.float32)
          for _ in range(2)]
    return q, *kv


def jax_linformer_E(n, proj_dim=64, seed=0):
    """The reference's Linformer draw (core/baselines.py:36-37)."""
    E = jax.random.normal(jax.random.PRNGKey(seed), (n, proj_dim), jnp.float32)
    return np.array(E / (proj_dim**0.5))


def jax_performer_W(d, num_features=64, seed=0):
    """The reference's Performer draw (core/baselines.py:49-59)."""
    key = jax.random.PRNGKey(seed)
    blocks = []
    for _ in range(num_features // d + 1):
        key, sub = jax.random.split(key)
        blocks.append(jnp.linalg.qr(jax.random.normal(sub, (d, d)))[0].T)
    W = jnp.concatenate(blocks, axis=0)[:num_features]
    norms = jnp.sqrt(jax.random.chisquare(key, d, (num_features,)))
    return np.array(W * norms[:, None])


def jax_bigbird_idx(nb, num_random=3, seed=0):
    """The reference's BigBird draw (core/baselines.py:170-171)."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed),
                                       (nb, num_random), 0, nb))


def _draws(kind, N, D, **kw):
    seed = kw.get("seed", 0)
    if kind == "linformer":
        return {"E": jax_linformer_E(N, kw.get("proj_dim", 64), seed)}
    if kind == "performer":
        return {"W": jax_performer_W(D, kw.get("num_features", 64), seed)}
    if kind == "bigbird":
        nb = N // kw.get("window", 64)
        return {"rand_idx": jax_bigbird_idx(nb, kw.get("num_random", 3), seed)}
    return {}


CASES = [
    ("linformer", {}), ("linformer", dict(proj_dim=32, seed=3)),
    ("performer", {}), ("performer", dict(num_features=40, seed=2)),
    ("nystromformer", {}), ("nystromformer", dict(num_landmarks=16,
                                                   pinv_iters=4)),
    ("longformer", {}), ("longformer", dict(window=32, num_global=8)),
    ("bigbird", {}), ("bigbird", dict(window=32, num_global=4, num_random=2,
                                      seed=5)),
    ("h_transformer_1d", {}), ("h_transformer_1d", dict(block=16)),
    ("full", {}),
]


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("kind,kw", CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_baseline_matches_reference(kind, kw, D):
    q, k, v = _qkv(D + len(kw), D=D)
    want = np.asarray(JB.REGISTRY[kind](*map(jnp.asarray, (q, k, v)), **kw))
    got = TB.REGISTRY[kind](*map(torch.from_numpy, (q, k, v)), **kw,
                            **_draws(kind, q.shape[2], D, **kw))
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("kind", sorted(TB.REGISTRY))
def test_self_attention_routes_every_registry_key(kind, G):
    """``self_attention`` of every ``REGISTRY`` key equals the reference's,
    GQA included (KV heads expanded G-fold), the draws the reference's."""
    H, N, D = 4, 128, 16
    q, k, v = _qkv(11 + G, H=H, N=N, D=D, Hkv=H // G)
    jspec = JA.AttentionSpec(kind=kind, softmax_scale=0.3)
    want = np.asarray(JA.self_attention(*map(jnp.asarray, (q, k, v)), jspec))
    draws = {"E": jax_linformer_E(N), "W": jax_performer_W(D),
             "rand_idx": jax_bigbird_idx(N // 64)}
    with mock.patch.object(TB, "linformer_projection",
                           lambda *a: torch.from_numpy(draws["E"])), \
            mock.patch.object(TB, "performer_features",
                              lambda *a: torch.from_numpy(draws["W"])), \
            mock.patch.object(TB, "bigbird_random_blocks",
                              lambda *a: torch.from_numpy(draws["rand_idx"])):
        got = TA.self_attention(*map(torch.from_numpy, (q, k, v)),
                                TA.AttentionSpec(kind=kind, softmax_scale=0.3))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_default_draws_are_fixed_by_the_seed():
    E = TB.linformer_projection(128, 64, seed=1)
    assert E.shape == (128, 64) and torch.equal(
        E, TB.linformer_projection(128, 64, seed=1))
    assert not torch.equal(E, TB.linformer_projection(128, 64, seed=2))
    assert abs(float(E.std()) * 8 - 1.0) < 0.05  # std 1/sqrt(64)
    W = TB.performer_features(16, 40, seed=0)
    norms = W.norm(dim=-1)
    rows = W / norms[:, None]
    for blk in (rows[:16], rows[16:32]):  # orthonormal blocks
        assert torch.allclose(blk @ blk.T, torch.eye(16), atol=1e-5)
    assert torch.equal(W, TB.performer_features(16, 40, seed=0))
    assert 2.0 < float(norms.mean()) < 6.0  # chi(16): mean ~3.94
    idx = TB.bigbird_random_blocks(8, 3, seed=0)
    assert idx.shape == (8, 3) and int(idx.min()) >= 0 and int(idx.max()) < 8
    q, k, v = map(torch.from_numpy, _qkv(0))
    for kind in ("linformer", "performer", "bigbird"):
        a = TB.REGISTRY[kind](q, k, v)
        assert torch.equal(a, TB.REGISTRY[kind](q, k, v)), kind


def test_serving_attends_exactly_under_baseline_kinds():
    """As in the reference, decode and chunk attention under a baseline
    kind are exact (the baselines approximate full sequences only); an
    unknown kind raises, ``local`` names its slice."""
    r = np.random.default_rng(3)
    B, H, S, D = 2, 2, 32, 16
    q = torch.from_numpy(r.standard_normal((B, H, 1, D)).astype(np.float32))
    kc, vc = (torch.from_numpy(r.standard_normal((B, H, S, D)).astype(
        np.float32)) for _ in range(2))
    lengths = torch.tensor([20, 32], dtype=torch.int32)
    want = TA.decode_attention(q, kc, vc, lengths, TA.AttentionSpec(kind="full"))
    got = TA.decode_attention(q, kc, vc, lengths,
                              TA.AttentionSpec(kind="linformer"))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown attention kind"):
        TA.self_attention(q, kc, vc, TA.AttentionSpec(kind="mamba"))
    with pytest.raises(NotImplementedError, match="recurrentgemma"):
        TA.self_attention(q, kc, vc, TA.AttentionSpec(kind="local"))
