"""Port parity on a (data, model) = (2, 2) mesh: training.

Four gloo ranks on the CPU, spawned once for the file (``launch.mesh.spawn``
with a ``FileStore`` under a temp dir; the ranks run
``torch_dist_ranks.run_cases``, which imports no JAX). The references are
computed here, in the test process, on the same numpy inputs: the JAX
package for the model, the port on one device for attention and the
optimizer. Tolerances are the reference's shard tier's
(tests/test_shard_parity.py, tests/test_dist_cpu.py):

  * MRA-2 self-attention on each rank's (batch, kv-head) block, causal x
    padded: forward 1e-5, gradients 1e-4 against the same block of the
    one-device call;
  * the qwen3-1.7b smoke model (fp32, the reference's weights): logits
    5e-4, loss 1e-4 and every gradient block (averaged over the data axis)
    5e-3 against the JAX single-device ``value_and_grad``; the same for
    the hubert encoder and the internvl VLM at their smoke configs;
  * one ZeRO-1 train step against the unsharded optimizer on one device
    (grad norm 1e-5 relative, parameters ``_step_tol``), the moments split
    over the data axis;
  * MoE ``psum`` (expert-parallel), the TP fallback (experts that do not
    divide the model axis) and ``a2a`` against the local path, 1e-3, with
    a capacity that drops nothing (the mesh sizes capacity from each
    rank's tokens, as the reference does);
  * a checkpoint written by ``train()`` on (2, 2) and restored on (1, 4):
    the blocks bitwise, and the resumed step within 1e-4 of one device;
  * ``logical_to_pspec`` / ``zero_pspec`` against the reference's for every
    preset's parameter tree on a duck-typed (2, 4) mesh, and the port's
    ``TensorSpec.axes`` against the reference's ``ParamSpec.axes``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.distributed.shard_attn import attention_partition as jax_partition
from repro.distributed.sharding import logical_to_pspec as jax_l2p
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.models import transformer as JT
from repro.models.params import ParamSpec
from repro.optim.adamw import zero_pspec as jax_zero_pspec
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.attention import AttentionSpec, self_attention
from repro_torch.distributed.sharding import (
    attention_partition,
    attention_pspec,
    local_block,
    logical_to_pspec,
)
from repro_torch.launch.mesh import spawn
from repro_torch.models import transformer as TT
from repro_torch.models.moe import moe_block, moe_specs
from repro_torch.models.params import (
    init_params,
    param_specs,
    tree_leaves,
)
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import zero_pspec
from repro_torch.train import TrainConfig, make_train_step, train
from test_torch_families import FAMILIES
from test_torch_families import _batch as fam_batch
from test_torch_families import _configs as fam_configs
from test_torch_families import _weights as fam_weights
from test_torch_train import _configs, _kernel_route, _shapes, _step_tol, _weights

MESH = (2, 2)
ARCH = "qwen3-1.7b"
LR = 1e-3
ATTN = dict(B=4, Hq=4, Hkv=2, N=96, D=16, b=16, bpr=3)  # N pads to 112
MOE_ARCH = "kimi-k2-1t-a32b"
# experts 4 / 5 over |model| = 2: expert-parallel / the TP fallback; a
# capacity factor of E / top_k drops nothing at any token count
MOE = {"ep": dict(num_experts=4, dispatch="psum"),
       "tp": dict(num_experts=5, dispatch="psum"),
       "a2a": dict(num_experts=4, dispatch="a2a")}
ELASTIC = dict(mesh_a=(2, 2), mesh_b=(1, 4), shape=(32, 4), steps=3)


class DuckMesh:
    """The reference reads only ``mesh.shape``; the port's block cutters
    also read a rank's coordinate."""

    def __init__(self, shape, rank=0):
        self.shape = dict(shape)
        names = list(self.shape)
        idx, coords = rank, {}
        for a in reversed(names):
            coords[a] = idx % self.shape[a]
            idx //= self.shape[a]
        self._coords = coords

    def index(self, axis):
        return self._coords[axis]


def _mesh(rank, shape=MESH):
    return DuckMesh({"data": shape[0], "model": shape[1]}, rank)


def _attention_inputs():
    a = ATTN
    r = np.random.default_rng(0)
    q = r.standard_normal((a["B"], a["Hq"], a["N"], a["D"])).astype(np.float32)
    k = r.standard_normal((a["B"], a["Hkv"], a["N"], a["D"])).astype(np.float32)
    v = r.standard_normal((a["B"], a["Hkv"], a["N"], a["D"])).astype(np.float32)
    masks = [np.ones((a["B"], a["N"]), bool), r.random((a["B"], a["N"])) > 0.25]
    return q, k, v, masks


def _attention_ref(q, k, v, masks):
    spec = AttentionSpec(kind="mra2", block_size=ATTN["b"],
                         blocks_per_row=ATTN["bpr"])
    out = []
    for causal in (False, True):
        for km in masks:
            ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
            o = self_attention(*ts, spec, causal=causal,
                               key_mask=torch.from_numpy(km))
            grads = torch.autograd.grad(torch.tanh(o).sum(), ts)
            out.append((o.detach().numpy(), [g.numpy() for g in grads]))
    return out


def _moe_cfg(case):
    m = MOE[case]
    base = get_smoke_config(MOE_ARCH, activ_dtype="float32")
    spec = dataclasses.replace(base.moe, num_experts=m["num_experts"],
                               capacity_factor=m["num_experts"] / base.moe.top_k)
    return {"activ_dtype": "float32", "moe": spec,
            "moe_dispatch": m["dispatch"]}


def _moe_inputs(cfg):
    r = np.random.default_rng(1)
    p = init_params(cfg.replace(num_layers=1), seed=2, device="cpu")
    w = {k: v.numpy() for k, v in p["layers"][0]["moe"].items()}
    x = r.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    return w, x


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs and references, then one spawn of the (2, 2) group."""
    q, k, v, masks = _attention_inputs()
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, tcfg)
    jshape, _ = _shapes(batch=4)
    batch = jax_make_batch(jcfg, jshape, step=1, seed=3)
    moe = {case: (_moe_cfg(case),) + _moe_inputs(get_smoke_config(
        MOE_ARCH, **_moe_cfg(case))) for case in MOE}
    ckpt = str(tmp_path_factory.mktemp("elastic"))
    families = {}
    for fam, arch in FAMILIES.items():
        fjcfg, ftcfg = fam_configs(arch)
        fjp, _ = fam_weights(fjcfg, ftcfg)
        families[fam] = (fjcfg, fjp, fam_batch(fjcfg, batch=4))
    cases = [
        ("attention", dict(mesh_shape=MESH, q=q, k=k, v=v, masks=masks,
                           block_size=ATTN["b"],
                           blocks_per_row=ATTN["bpr"])),
        ("train_step", dict(mesh_shape=MESH, arch=ARCH,
                            overrides={"activ_dtype": "float32"},
                            weights=jax.device_get(jp), batch=batch, lr=LR)),
        *[(f"moe:{case}", dict(mesh_shape=MESH, arch=MOE_ARCH,
                               overrides=ov, weights=w, x=x))
          for case, (ov, w, x) in moe.items()],
        ("elastic", dict(arch=ARCH, overrides={"activ_dtype": "float32"},
                         ckpt_dir=ckpt, **ELASTIC)),
        *[(f"train_step:{fam}", dict(mesh_shape=MESH, arch=FAMILIES[fam],
                                     overrides={"activ_dtype": "float32"},
                                     weights=fw, batch=fb, lr=LR))
          for fam, (_, fw, fb) in families.items()],
    ]
    got = spawn(R.run_cases, 4, cases, device="cpu", threads=1)
    return {"got": got, "attn_in": (q, k, v, masks), "jcfg": jcfg,
            "tcfg": tcfg, "jp": jp, "tp": tp, "batch": batch, "moe": moe,
            "ckpt": ckpt, "families": families}


@pytest.fixture(scope="module")
def attn_ref(run):
    return _attention_ref(*run["attn_in"])


@pytest.mark.parametrize("i", range(4), ids=["bidir-full", "bidir-padded",
                                             "causal-full", "causal-padded"])
def test_attention_blocks_match_one_device(run, attn_ref, i):
    want_o, want_g = attn_ref[i]
    for rank, res in enumerate(run["got"]):
        mesh = _mesh(rank)
        parts = res["attention"]["parts"]
        assert parts == ("data", "model")
        o, grads = res["attention"]["out"][i]
        blk = lambda a: local_block(torch.from_numpy(a),  # noqa: E731
                                    attention_pspec(parts, a.ndim), mesh)
        np.testing.assert_allclose(o, blk(want_o).numpy(), rtol=0, atol=1e-5)
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(g, blk(w).numpy(), rtol=0, atol=1e-4)


def _jax_step(jcfg, jp, batch):
    """The JAX single-device loss, logits and gradient leaves."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with _kernel_route():
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: JT.loss_fn(p, jcfg, jb), has_aux=True))(jp)
        jlogits, _ = jax.jit(lambda p: JT.forward(
            p, jcfg, {k: v for k, v in jb.items() if k != "targets"}))(jp)
    return (float(jl), np.asarray(jlogits),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(
                jax.device_get(jg))])


@pytest.fixture(scope="module")
def jax_step(run):
    return _jax_step(run["jcfg"], run["jp"], run["batch"])


def _param_blocks(cfg, rank, leaves, mesh_of=_mesh):
    """The rank's blocks of a whole parameter-leaf list."""
    from repro_torch.distributed.sharding import param_placements
    from repro_torch.optim.adamw import tree_leaves_pspec

    mesh = mesh_of(rank)
    pl = tree_leaves_pspec(param_placements(cfg, mesh))
    return [local_block(torch.as_tensor(np.asarray(x)), ps, mesh).numpy()
            for x, ps in zip(leaves, pl)]


def _check_step(got_by_rank, key, tcfg, jax_ref, mesh_of=_mesh):
    jl, jlogits, jgrads = jax_ref
    for rank, res in enumerate(got_by_rank):
        got = res[key]
        rows = local_block(torch.from_numpy(jlogits), ("data", None, None),
                           mesh_of(rank)).numpy()
        assert np.abs(got["logits"] - rows).max() < 5e-4
        assert abs(got["loss"] - jl) < 1e-4
        want = _param_blocks(tcfg, rank, jgrads, mesh_of)
        assert len(got["grads"]) == len(want)
        assert max(np.abs(g - w).max() for g, w in
                   zip(got["grads"], want)) < 5e-3


def test_train_step_logits_loss_grads_match_jax(run, jax_step):
    _check_step(run["got"], "train_step", run["tcfg"], jax_step)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_train_step_matches_jax(run, family):
    """hubert (masked-unit loss over the whole batch's masked positions,
    layernorm, gelu MLP with biases, learned positions) and internvl
    (patches before the text) through the same mesh step."""
    jcfg, jp, batch = run["families"][family]
    _, tcfg = fam_configs(FAMILIES[family])
    _check_step(run["got"], f"train_step:{family}", tcfg,
                _jax_step(jcfg, jp, batch))


def test_zero1_step_matches_unsharded_optimizer(run):
    tcfg, tp = run["tcfg"], run["tp"]
    step = make_train_step(tcfg, TrainConfig(), AdamW(),
                           cosine_schedule(LR, 1, 10))
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    tp = {k: v for k, v in tp.items()}
    tp2, state, met = step(tp, AdamW().init(tp), batch)
    want = [p.detach().numpy() for p in tree_leaves(tp2)]
    full = [p.shape for p in tree_leaves(tp2)]
    for rank, res in enumerate(run["got"]):
        got = res["train_step"]
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   float(met["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["loss"], float(met["loss"]),
                                   rtol=0, atol=1e-4)
        for g, w in zip(got["params"], _param_blocks(tcfg, rank, want)):
            np.testing.assert_allclose(g, w, rtol=0, atol=_step_tol(LR))
        # ZeRO-1: some moments hold half of their block's largest dim
        shapes = got["moment_shapes"]
        blocks = [b.shape for b in _param_blocks(tcfg, rank, want)]
        assert any(s != b for s, b in zip(shapes, blocks))
        assert all(np.prod(s) * 2 == np.prod(b) or s == b
                   for s, b in zip(shapes, blocks))
        assert len(full) == len(shapes)


@pytest.mark.parametrize("case", list(MOE))
def test_moe_dispatch_matches_local_path(run, case):
    ov, w, x = run["moe"][case]
    cfg = get_smoke_config(MOE_ARCH, **ov)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = moe_block(xt, p, cfg)
    leaves = [xt] + [p[k] for k in sorted(p)]
    want_g = torch.autograd.grad((out ** 2).sum(), leaves)
    # the aux losses: the mean over the data shards of each shard's
    aux_want = {}
    for half in np.split(x, MESH[0]):
        _, a = moe_block(torch.from_numpy(half), p, cfg)
        for kk, vv in a.items():
            aux_want[kk] = aux_want.get(kk, 0.0) + float(vv) / MESH[0]
    weight_sum = None
    specs = moe_specs(cfg)
    for rank, res in enumerate(run["got"]):
        got = res[f"moe:{case}"]
        mesh = _mesh(rank)
        rows = local_block(out.detach(), ("data", None, None), mesh).numpy()
        assert np.abs(got["out"] - rows).max() < 1e-3
        for kk in aux_want:
            assert abs(got["aux"][kk] - aux_want[kk]) < 1e-3
        gx = local_block(want_g[0], ("data", None, None), mesh).numpy()
        assert np.abs(got["grads"][0] - gx).max() < 1e-3
        if mesh.index("data") == 0:  # weight blocks: summed over the data
            partner = run["got"][rank + MESH[1]][f"moe:{case}"]["grads"]
            for g, g2, kk in zip(got["grads"][1:], partner[1:], sorted(p)):
                s = specs[kk]
                ps = logical_to_pspec(s.shape, s.axes, mesh)
                w_blk = local_block(want_g[1 + sorted(p).index(kk)], ps,
                                    mesh).numpy()
                err = np.abs(g + g2 - w_blk).max()
                weight_sum = err if weight_sum is None else max(weight_sum,
                                                                err)
        if case == "a2a":
            assert got["comm"]["ops"]["all_to_all"]["calls"] >= 2
    assert weight_sum < 1e-3


def test_checkpoint_saved_on_2x2_restores_on_1x4(run):
    tcfg = run["tcfg"]
    seq, gb = ELASTIC["shape"]
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.checkpoint import restore

    shp = ShapeCfg(seq, gb)
    seen = {}
    tc = TrainConfig(steps=ELASTIC["steps"], warmup=1, lr=1e-3, log_every=100)
    train(tcfg, shp, tc, device="cpu",
          on_metrics=lambda s, m: seen.__setitem__(s, m))
    like = init_params(tcfg, seed=1, device="cpu")
    whole = restore(run["ckpt"], ELASTIC["steps"] - 1, like)
    wl = [t.numpy() for t in tree_leaves(whole)]
    mb = ELASTIC["mesh_b"]
    for rank, res in enumerate(run["got"]):
        got = res["elastic"]
        mesh = _mesh(rank, mb)
        from repro_torch.distributed.sharding import param_placements
        from repro_torch.optim.adamw import tree_leaves_pspec

        pl = tree_leaves_pspec(param_placements(tcfg, mesh))
        for g, w, ps in zip(got["restored"], wl, pl):
            assert np.array_equal(g, local_block(torch.from_numpy(w), ps,
                                                 mesh).numpy())
        for s in range(ELASTIC["steps"] - 1):
            assert abs(got["metrics"]["a"][s]["loss"] - seen[s]["loss"]) < 1e-4
        last = ELASTIC["steps"] - 1
        assert set(got["metrics"]["b"]) == {last}  # resumed at the last step
        for key in ("loss", "grad_norm"):
            assert abs(got["metrics"]["b"][last][key] - seen[last][key]) \
                < 1e-4 * max(1.0, abs(seen[last][key]))


def _jax_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, ParamSpec))[0]


def _port_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _port_leaves(tree[k], f"{path}['{k}']")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in
                _port_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_axes_and_placements_match_reference(arch):
    """Every preset's parameter tree (and its serving cache's): the axes of
    every leaf equal the reference's ``ParamSpec.axes``, and on a (2, 4)
    mesh ``logical_to_pspec`` and ``zero_pspec`` equal the reference's."""
    jcfg = jax_get_config(arch).replace(scan_layers=False)
    tcfg = get_config(arch)
    jm, tm = jax_get_model(jcfg), get_model(tcfg)
    mesh = DuckMesh({"data": 2, "model": 4})
    trees = ((jm.param_specs(jcfg), param_specs(tcfg)),
             (jm.cache_specs(jcfg, 4, 256), tm.cache_specs(tcfg, 4, 256)))
    for jtree, ttree in trees:
        jl = [(jax.tree_util.keystr(p), s) for p, s in _jax_leaves(jtree)]
        tl = _port_leaves(ttree)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, js), (_, ts) in zip(jl, tl):
            assert tuple(js.axes) == ts.axes and tuple(js.shape) == ts.shape, path
            jps = jax_l2p(js.shape, js.axes, mesh)
            tps = logical_to_pspec(ts.shape, ts.axes, mesh)
            assert tuple(jps) == tps, path
            assert tuple(jax_zero_pspec(js.shape, mesh, base=jps)) == \
                zero_pspec(ts.shape, mesh, base=tps), path


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"pod": 2, "data": 2, "model": 2},
                                   {"data": 1, "model": 1}],
                         ids=["2x4", "2x2x2", "1x1"])
def test_attention_partition_matches_reference(shape):
    """The port places attention operands as the reference's shard_map
    cuts them: the batch over the widest dividing data axes, the kv heads
    over "model" when they divide it, None when neither splits."""
    mesh = DuckMesh(shape)

    def norm(part):  # 'data' and ('data',) are the same placement
        return (part,) if isinstance(part, str) else part

    for batch in (1, 2, 3, 4, 8):
        for kv in (1, 2, 3, 4, 8):
            got = attention_partition(mesh, batch, kv)
            want = jax_partition(mesh, batch, kv)
            if want is None:
                assert got is None, (batch, kv)
            else:
                assert (norm(got[0]), got[1]) == want, (batch, kv)
