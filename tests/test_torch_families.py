"""Port parity: the hubert encoder and the internvl VLM vs the JAX package.

At the hubert-xlarge and internvl2-1b smoke configs with fp32 activations,
the reference's weights carried over by ``params_from_jax`` and batches
from both data pipelines, on the CPU:

  * ``make_batch`` bitwise equal to the reference's (frames, the 8% mask
    and the projected targets; tokens then patches), sharded too, and the
    ``DataLoader`` hands the new keys on unchanged;
  * ``layer_norm`` (biased fp32 variance at ``norm_eps``) and the gelu MLP
    (``jax.nn.gelu``'s tanh form) within 1e-6 (atol and rtol: outputs of
    order 5 differ by fp32 rounding);
  * ``forward`` logits, ``loss_fn`` within 1e-5 (hubert: the masked
    positions' mean; internvl: the text after the patches), and every
    parameter gradient within 1e-4 of the leaf's largest entry — hubert is
    non-causal, internvl causal with G = 2. hubert's logits hold at 1e-5,
    the head-dim-80 layer's at 3e-5 and internvl's at 1e-4 (``LOGIT_TOL``,
    the tolerance tests/test_torch_train.py gives a two-layer fp32 model):
    they part from the reference's by 1.4e-5 and 4.9e-5 (of logits up to
    1.0 and 4.0). That is fp32 rounding: against an fp64 evaluation of
    the same model the reference's own logits are off by 1.1e-5 and
    8.2e-5, the port's by 9.3e-6 and 5.4e-5, which
    ``test_fp32_logits_as_close_to_fp64_as_the_reference`` holds;
  * internvl's whole-prompt ``prefill`` of patches and text, then eight
    ``decode_step``s fed their own greedy tokens: logits within 1e-4 and
    the greedy tokens exact;
  * head dim 80 at block size 128, the shape the CUDA kernels gained for
    hubert-xlarge: a one-layer hubert at seq 512 (loss and gradients as
    above), and the three plain block-sparse twins (the kernels' CPU
    route) against ``repro/kernels/ref.py`` and the Pallas kernels in
    interpret mode, causal and non-causal;
  * the presets equal the reference's field for field, and ``train()``
    counts the positions a step trains (frames; patches plus text); the
    registry's cases are in tests/test_torch_moe.py.

The reference runs its kernel route (``attn_use_kernel``, jnp backward,
ref.py in place of the Pallas forward), the contract the port implements
(tests/test_torch_train.py says why).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import make_batch as jax_make_batch
from repro.kernels import ops as jops
from repro.kernels.ref import block_sparse_attention_bwd_ref as jax_bwd_ref
from repro.kernels.ref import block_sparse_attention_ref as jax_fwd_ref
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.mra import MraConfig, kernel_pairs, select_blocks
from repro_torch.data import DataLoader, make_batch
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.params import (params_from_jax, tree_leaves,
                                       tree_unflatten)
from repro_torch.serve.cache import RingPagedKVCache
from repro_torch.train import TrainConfig, train
from test_torch_train import _kernel_route, _max_rel, _shapes

FAMILIES = {"hubert": "hubert-xlarge", "internvl": "internvl2-1b"}
LOGIT_TOL = {"hubert": 1e-5, "internvl": 1e-4, "head_dim_80": 3e-5}
SEQ, BATCH = 64, 2  # 4 blocks of 16, budget 8 of 16 (hubert): a background


def _configs(arch, **kw):
    kw.setdefault("activ_dtype", "float32")
    jcfg = jax_smoke(arch, attn_use_kernel=True, attn_kernel_bwd="jnp", **kw)
    return jcfg, get_smoke_config(arch, **kw)


def _weights(jcfg, tcfg, seed=0):
    jp = jax.device_get(jax_init(jax_get_model(jcfg).param_specs(jcfg),
                                 jax.random.PRNGKey(seed)))
    # the reference initializes biases, LayerNorm shifts and mask_embed at
    # 0 / the embed std; random values hold their wiring too
    r = np.random.default_rng(seed + 7)

    def perturb(path, a):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] in ("b", "bi", "bo"):
            return (np.asarray(a) + 0.1 * r.standard_normal(a.shape)).astype(
                np.asarray(a).dtype)
        return a

    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    tp = params_from_jax(jp, tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return jp, tp


def _batch(jcfg, seq=SEQ, batch=BATCH, step=1, seed=3):
    jshape, _ = _shapes(seq, batch)
    return jax_make_batch(jcfg, jshape, step=step, seed=seed)


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seq,batch,step,seed", [(64, 2, 0, 0), (48, 3, 5, 7)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_make_batch_bitwise(family, seq, batch, step, seed):
    jcfg, tcfg = jax_smoke(FAMILIES[family]), get_smoke_config(FAMILIES[family])
    jshape, tshape = _shapes(seq, batch)
    for kw in ({}, dict(shard=1, num_shards=2, batch_override=2)):
        want = jax_make_batch(jcfg, jshape, step=step, seed=seed, **kw)
        got = make_batch(tcfg, tshape, step=step, seed=seed, **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loader_carries_the_family_keys(family):
    cfg = get_smoke_config(FAMILIES[family])
    _, shape = _shapes(32, 2)
    loader = DataLoader(cfg, shape, seed=2, start_step=1)
    try:
        got = [next(loader) for _ in range(2)]
    finally:
        loader.close()
    for step, batch in got:
        want = make_batch(cfg, shape, step=step, seed=2)
        assert set(batch) == set(want)
        assert all(np.array_equal(batch[k], want[k]) for k in want)


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def test_layer_norm_and_gelu_mlp_match_jax():
    _, tcfg = _configs("hubert-xlarge")
    jcfg = jax_smoke("hubert-xlarge", activ_dtype="float32")
    r = np.random.default_rng(0)
    d, f = tcfg.d_model, tcfg.d_ff
    x = (3.0 * r.standard_normal((2, 5, d)) + 1.5).astype(np.float32)
    w, b = (r.standard_normal(d).astype(np.float32) for _ in range(2))
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    p = {"wi": r.standard_normal((d, f)) / 8, "bi": r.standard_normal(f),
         "wo": r.standard_normal((f, d)) / 11, "bo": r.standard_normal(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = JL.mlp_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                        jcfg)
    got = TL.mlp_block(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in p.items()}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.tensor([1.0]))
    assert float(TL.F.gelu(torch.tensor([1.0]), approximate="tanh")) != float(
        exact)  # the tanh form is not torch's default


# --------------------------------------------------------------------------- #
# forward, loss and gradients
# --------------------------------------------------------------------------- #
def _jax_loss_and_grads(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return JT.loss_fn(p, jcfg, jb)

    with _kernel_route():
        (jl, jmet), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
        jlogits, _ = jax.jit(lambda p: JT.forward(p, jcfg, jb))(jp)
    return jl, jmet, jg, jlogits


def _hold_loss_and_grads(jcfg, tcfg, jp, tp, batch, logit_tol):
    jl, jmet, jg, jlogits = _jax_loss_and_grads(jcfg, jp, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, tmet = TT.loss_fn(tp, tcfg, tb)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    with torch.no_grad():
        tlogits, _ = TT.forward(tp, tcfg, tb)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=logit_tol)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["nll"].detach()), float(jmet["nll"]),
                               rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jax.device_get(jg))
    assert len(jleaves) == len(tg)
    worst = max(_max_rel(g.numpy(), w) for g, w in zip(tg, jleaves))
    assert worst < 1e-4, worst
    return float(tl.detach())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_loss_and_gradients_match_jax(family):
    jcfg, tcfg = _configs(FAMILIES[family])
    assert tcfg.causal == (family == "internvl")
    jp, tp = _weights(jcfg, tcfg)
    batch = _batch(jcfg)
    if family == "hubert":
        assert batch["mask_positions"].any()
    _hold_loss_and_grads(jcfg, tcfg, jp, tp, batch, LOGIT_TOL[family])


def test_hubert_loss_without_masked_positions_is_zero():
    """sum / max(count, 1): no masked position gives a zero loss, as in the
    reference."""
    jcfg, tcfg = _configs("hubert-xlarge")
    jp, tp = _weights(jcfg, tcfg)
    batch = _batch(jcfg)
    batch["mask_positions"][:] = False
    jl, *_ = _jax_loss_and_grads(jcfg, jp, batch)
    tl, _ = TT.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert float(tl.detach()) == 0.0 == float(jl)


# --------------------------------------------------------------------------- #
# internvl serving: whole-prompt prefill with patches, then decode
# --------------------------------------------------------------------------- #
def test_internvl_prefill_then_decode_matches_jax():
    arch = "internvl2-1b"
    jcfg = jax_smoke(arch, activ_dtype="float32")
    tcfg = get_smoke_config(arch, activ_dtype="float32")
    jp, tp = _weights(jcfg, tcfg)
    B, max_len, steps = 2, 64, 8
    batch = _batch(jcfg, seq=48, batch=B)  # 8 patches + 40 text tokens
    jc = jax_init(JT.cache_specs(jcfg, B, max_len), jax.random.PRNGKey(1))
    jlog, jc = JT.prefill(jp, jcfg, {k: jnp.asarray(batch[k]) for k in
                                     ("tokens", "patches")}, jc)
    tc = RingPagedKVCache(tcfg, B, max_len, device="cpu").tree
    with torch.no_grad():
        tlog, tc = TT.prefill(tp, tcfg, {k: torch.from_numpy(batch[k]) for k
                                         in ("tokens", "patches")}, tc)
    assert tc["lengths"].tolist() == [48] * B
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    jtok = ttok = np.asarray(jlog).argmax(-1)
    for _ in range(steps):
        jlog, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(jtok, jnp.int32))
        with torch.no_grad():
            tlog, tc = TT.decode_step(tp, tcfg, tc, torch.as_tensor(ttok))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
        jtok, ttok = np.asarray(jlog).argmax(-1), tlog.numpy().argmax(-1)
        assert np.array_equal(jtok, ttok)
    assert tc["lengths"].tolist() == [48 + steps] * B


# --------------------------------------------------------------------------- #
# head dim 80 at block size 128 (hubert-xlarge's kernel shape)
# --------------------------------------------------------------------------- #
def _d80_configs():
    """A one-layer hubert at hubert-xlarge's attention shape: head dim 80,
    b = 128, two blocks a row."""
    from repro.core.attention import AttentionSpec as JSpec
    from repro_torch.core.attention import AttentionSpec as TSpec

    kw = dict(num_layers=1, head_dim=80, d_model=160, num_heads=2,
              kv_heads=2, frontend_dim=32)
    jcfg, tcfg = _configs("hubert-xlarge", **kw)
    return (jcfg.replace(attention=JSpec(kind="mra2", block_size=128,
                                         blocks_per_row=2)),
            tcfg.replace(attention=TSpec(kind="mra2", block_size=128,
                                         blocks_per_row=2)))


def test_hubert_head_dim_80_one_layer_matches_jax():
    """The one-layer hubert at head dim 80 over seq 512: the loss and every
    gradient through the plain twins, against the reference."""
    jcfg, tcfg = _d80_configs()
    assert tcfg.hd == 80 and (80, 128) in bsa.KERNEL_SHAPES
    jp, tp = _weights(jcfg, tcfg)
    _hold_loss_and_grads(jcfg, tcfg, jp, tp, _batch(jcfg, seq=512, batch=1),
                         LOGIT_TOL["head_dim_80"])


@pytest.mark.parametrize("case", ["internvl", "head_dim_80"])
def test_fp32_logits_as_close_to_fp64_as_the_reference(case):
    """Where the port's fp32 logits part from the reference's by more than
    1e-5, both are fp32 roundings of one function: each lies within its
    ``LOGIT_TOL`` of the port's fp64 evaluation of the model, and the port
    no farther from it than the reference (margin 1.5)."""
    if case == "internvl":
        jcfg, tcfg = _configs("internvl2-1b")
        batch = _batch(jcfg)
    else:
        jcfg, tcfg = _d80_configs()
        batch = _batch(jcfg, seq=512, batch=1)
    jp, tp = _weights(jcfg, tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with _kernel_route():
        jlog = np.asarray(jax.jit(lambda p: JT.forward(p, jcfg, jb))(jp)[0])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tlog = TT.forward(tp, tcfg, tb)[0].numpy()
        wide = tree_unflatten(tp, [p.detach().double()
                                   for p in tree_leaves(tp)])
        exact = TT.forward(wide, tcfg.replace(activ_dtype="float64"), {
            k: v.double() if v.is_floating_point() else v
            for k, v in tb.items()})[0].numpy()
    port, ref = np.abs(tlog - exact).max(), np.abs(jlog - exact).max()
    assert max(port, ref) < LOGIT_TOL[case], (port, ref)
    assert port <= 1.5 * ref, (port, ref)


def _d80_inputs(causal, seed):
    """q (4, 512, 80), k / v (2, 512, 80) (G = 2), the pairs of a real MRA-2
    selection at b = 128, two blocks a row (the port's ``select_blocks``;
    the reference's selection lives inside its attention), the last 40
    keys masked."""
    r = np.random.default_rng(seed)
    n, d, b = 512, 80, 128
    q = r.standard_normal((1, 2, 2, n, d)).astype(np.float32)
    k = r.standard_normal((1, 2, n, d)).astype(np.float32)
    v = r.standard_normal((1, 2, n, d)).astype(np.float32)
    cfg = MraConfig(block_size=b, blocks_per_row=2, causal=causal)
    sel = select_blocks(*(torch.from_numpy(a) for a in (q, k, v)),
                        torch.ones((1, n), dtype=torch.bool), cfg, d ** -0.5)
    c, x, y, fl = (a.numpy() for a in kernel_pairs(sel, causal))
    kmr = np.broadcast_to(np.arange(n) < n - 40, (2, n)).astype(np.int32)
    return (q.reshape(4, n, d), k.reshape(2, n, d), v.reshape(2, n, d), c,
            x.astype(np.int32), y.astype(np.int32), fl.astype(np.int32), kmr)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_twins_at_head_dim_80_match_jax(causal):
    """The forward, dq and dk/dv plain twins (the kernels' CPU route) at
    (80, 128) against ``kernels/ref.py`` (forward 1e-5, gradients 1e-5 of
    their largest magnitude) and the autograd.Function against the Pallas
    kernels in interpret mode."""
    q, k, v, c, x, y, fl, km = _d80_inputs(causal, seed=5)
    kw = dict(scale=80 ** -0.5, block_size=128)
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, c, x, y, fl, km)]
    want = jax_fwd_ref(q, k, v, x, y, fl, c, km, **kw)
    got = bsa.block_sparse_attention_ref(t[0], t[1], t[2], t[4], t[5], t[6],
                                         t[3], t[7], **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    r = np.random.default_rng(9)
    do = r.standard_normal(q.shape).astype(np.float32)
    dr = r.standard_normal(q.shape[:2]).astype(np.float32)
    jd = jax_bwd_ref(q, k, v, c, x, y, fl, km, jnp.asarray(do),
                     jnp.asarray(dr), **kw)
    args = (*t[:3], t[3], t[4], t[5], t[6], t[7], torch.from_numpy(do),
            torch.from_numpy(dr))
    dq = bsa.block_sparse_attention_bwd_dq_ref(*args, **kw)
    dk, dv = bsa.block_sparse_attention_bwd_dkv_ref(*args, **kw)
    for g, w in zip((dq, dk, dv), jd):
        assert _max_rel(g.numpy(), w) < 1e-5

    def pallas(q, k, v):
        return jops.block_sparse_attention(q, k, v, jnp.asarray(c), x, y, fl,
                                           km, interpret=True, **kw)

    jout = jax.jit(pallas)(q, k, v)
    tq, tk, tv = (a.clone().requires_grad_(True) for a in t[:3])
    tout = bsa.block_sparse_attention(tq, tk, tv, t[3], t[4], t[5], t[6],
                                      t[7], **kw)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)
    jg = jax.jit(jax.grad(lambda q, k, v: jnp.sum(pallas(q, k, v)[0] * do)
                          + jnp.sum(pallas(q, k, v)[1] * dr),
                          argnums=(0, 1, 2)))(q, k, v)
    tg = torch.autograd.grad((tout[0] * torch.from_numpy(do)).sum()
                             + (tout[1] * torch.from_numpy(dr)).sum(),
                             (tq, tk, tv))
    for g, w in zip(tg, jg):
        assert _max_rel(g.numpy(), w) < 1e-5


# --------------------------------------------------------------------------- #
# presets, registry, training loop
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list(FAMILIES.values()))
def test_presets_equal_the_reference(arch):
    for got, want in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name, None), getattr(want, f.name)
            if f.name == "attention":
                assert dataclasses.asdict(g) == {
                    k: v for k, v in dataclasses.asdict(w).items()
                    if k in dataclasses.asdict(g)}
            elif hasattr(got, f.name):
                assert g == w, f.name
        for name in ("frontend", "frontend_dim", "num_patches", "max_seq",
                     "pos", "norm", "act", "causal"):
            assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("family,unit", [("hubert", "frames"),
                                         ("internvl", "patches+text")])
def test_train_counts_the_family_positions(family, unit, capsys):
    cfg = get_smoke_config(FAMILIES[family], activ_dtype="float32")
    _, shape = _shapes(32, 2)
    seen = []
    train(cfg, shape, TrainConfig(steps=2, log_every=1), device="cpu",
          on_metrics=lambda s, m: seen.append(m))
    assert capsys.readouterr().out.count(f" {unit}/s") == 2
    assert len(seen) == 2
    for m in seen:
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        # B·S positions: 2 x 32 frames, or 2 x (8 patches + 24 tokens)
        assert m["tokens_per_s"] == pytest.approx(64 / m["step_time_s"])
