"""Port parity on a (data, model) = (2, 2) mesh: the recurrent families.

Four gloo ranks on the CPU, spawned once for the file (see
test_torch_dist_train.py; the ranks run ``torch_dist_ranks.run_cases``,
which imports no JAX), against the JAX single device on the same numpy
inputs, at the tolerances the transformer families are held to there and
in test_torch_dist_serve.py:

  * training: the train step's logits (5e-4), loss (1e-4) and every
    gradient block averaged over the data axis (5e-3) for rwkv6 (heads and
    d_ff split over "model") and recurrentgemma, on its ``local`` kind and
    on the MRA-2 variant (b = 16, two blocks a row: the block-sparse
    autograd function on each rank's rows, its plain twins here), against
    the reference's ``value_and_grad``;
  * serving: ragged ``prefill_chunk`` calls then ``decode_step`` with one
    slot frozen over each rank's block of the state cache, then the
    whole-prompt ``prefill`` into a fresh one, against the reference's
    functions on the whole batch: every slot's logits 5e-4, every cache
    leaf of the rank's block 5e-4 (positions and lengths exact), the
    frozen slots' rows bit-identical across the call, and
    recurrentgemma's 32-entry ring wrapped;
  * the placement: each state cache's local shapes are ``local_shape`` of
    its specs under the mesh;
  * the mesh ``Engine`` on the reference's DP x TP requests
    (tests/test_recurrent_engine.py::test_recurrent_engine_dp_tp_parity):
    the greedy streams equal the JAX single-device engine's, the sampled
    one the port's own one-device stream, on every rank;
  * a checkpoint that rwkv6's ``train()`` wrote on (2, 2) restores on
    (1, 4): the blocks bitwise, and the resumed step within 1e-4 of one
    device.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.core.attention import AttentionSpec as JSpec
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.core.attention import AttentionSpec as TSpec
from repro_torch.distributed.sharding import (
    local_block,
    local_shape,
    logical_to_pspec,
    param_placements,
)
from repro_torch.launch.mesh import spawn
from repro_torch.models.params import init_params, params_from_jax, tree_leaves
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import tree_leaves_pspec
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams
from repro_torch.train import TrainConfig, train
from test_torch_dist_train import DuckMesh

MESH = (2, 2)
RWKV, RGEMMA = "rwkv6-7b", "recurrentgemma-9b"
MRA = dict(kind="mra2", block_size=16, blocks_per_row=2)
# (arch, MRA-2 local layers, sequence length of the train batch)
TRAIN = {"rwkv6": (RWKV, False, 32), "rgemma-local": (RGEMMA, False, 48),
         "rgemma-mra2": (RGEMMA, True, 48)}
SERVE = dict(slots=4, max_len=64, C=16)
# ragged chunks: slot 0 reaches 48 tokens (recurrentgemma's 32-entry ring
# wraps), slot 1 sits out the first and slot 3 the second; then decode
# steps, each with one slot frozen
CHUNK_NV = ((16, 0, 16, 7), (16, 9, 16, 0), (16, 16, 3, 16))
STEP_ACTIVE = ((True, False, True, True), (True, True, True, False),
               (False, True, True, True))
ENGINE = dict(slots=2, max_len=64, chunk=8)
SERVED = ((RWKV, "rwkv6"), (RGEMMA, "rgemma-local"))  # (arch, weights)
SAMPLED = dict(temperature=0.8, seed=13)
ELASTIC = dict(mesh_a=(2, 2), mesh_b=(1, 4), shape=(32, 4), steps=3)
TOL = dict(logits=5e-4, loss=1e-4, grads=5e-3, cache=5e-4)
# data_mean's buckets: a 25-entry tensor spans three 10-entry buckets
DATA_MEAN = dict(sizes=(25, 4, 3), bucket=10)


def _mesh(rank, shape=MESH):
    return DuckMesh({"data": shape[0], "model": shape[1]}, rank)


def _ov(mra=False, jax_spec=False):
    ov = {"activ_dtype": "float32"}
    if mra:
        ov["attention"] = (JSpec if jax_spec else TSpec)(**MRA)
    return ov


def _jcfg(arch, mra=False):
    return jax_smoke(arch, **_ov(mra, jax_spec=True))


def _weights(jcfg, seed=0):
    return jax.device_get(jax_init(jax_get_model(jcfg).param_specs(jcfg),
                                   jax.random.PRNGKey(seed)))


def _train_batch(jcfg, seq):
    shape = dataclasses.replace(JAX_SHAPES["train_4k"], seq_len=seq,
                                global_batch=4)
    return jax_make_batch(jcfg, shape, step=1, seed=3)


def _serve_inputs(vocab):
    r = np.random.default_rng(5)
    B, C = SERVE["slots"], SERVE["C"]
    chunks = [(r.integers(1, vocab, (B, C)).astype(np.int64),
               np.array(nv, np.int32)) for nv in CHUNK_NV]
    steps = [(r.integers(1, vocab, (B,)).astype(np.int64), np.array(a))
             for a in STEP_ACTIVE]
    return chunks, steps


def _prompt(vocab):
    """The whole-prompt ``prefill``'s tokens: every slot, 40 positions (a
    multiple of rwkv6's chunk, past recurrentgemma's 32-entry ring)."""
    return np.random.default_rng(6).integers(1, vocab, (SERVE["slots"], 40))


def _dp_tp_requests(vocab):
    """The reference's DP x TP requests: two greedy, one sampled."""
    return [(np.array([4, 8, 15]), 4), (np.arange(2, 38) % vocab, 5, SAMPLED),
            (np.array([14, 27]), 4)]


def recurrent_cases(mesh_shape):
    """(cases, inputs): the training, serving and engine cases of both
    families on ``mesh_shape`` for ``torch_dist_ranks.run_cases``, and the
    weights and batches they carry (test_torch_dist_shard.py runs them on
    (2, 4))."""
    weights, batches, cases = {}, {}, []
    for name, (arch, mra, seq) in TRAIN.items():
        jcfg = _jcfg(arch, mra)
        weights[name] = _weights(jcfg)
        batches[name] = _train_batch(jcfg, seq)
        cases.append((f"train_step:{name}", dict(
            mesh_shape=mesh_shape, arch=arch, overrides=_ov(mra),
            weights=weights[name], batch=batches[name], lr=1e-3)))
    for arch, name in SERVED:
        chunks, steps = _serve_inputs(_jcfg(arch).vocab)
        cases.append((f"state_serve:{arch}", dict(
            mesh_shape=mesh_shape, arch=arch, overrides=_ov(),
            weights=weights[name], chunks=chunks, steps=steps,
            slots=SERVE["slots"], max_len=SERVE["max_len"],
            prompt=_prompt(_jcfg(arch).vocab))))
        cases.append((f"engine:{arch}", dict(
            mesh_shape=mesh_shape, arch=arch, overrides=_ov(),
            weights=weights[name], mix=_dp_tp_requests(_jcfg(arch).vocab),
            spec_k=0, **ENGINE)))
    return cases, {"weights": weights, "batches": batches}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs and weights, then one spawn of the (2, 2) group."""
    cases, inputs = recurrent_cases(MESH)
    ckpt = str(tmp_path_factory.mktemp("elastic_rwkv6"))
    cases.append(("elastic", dict(arch=RWKV, overrides=_ov(), ckpt_dir=ckpt,
                                  **ELASTIC)))
    cases.append(("data_mean", dict(mesh_shape=MESH, **DATA_MEAN)))
    got = spawn(R.run_cases, 4, cases, device="cpu", threads=1)
    return {"got": got, "ckpt": ckpt, **inputs}


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def _jax_step(jcfg, jp, batch):
    """The JAX single-device loss, logits and gradient leaves (jitted)."""
    model = jax_get_model(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, jcfg, jb), has_aux=True))(jp)
    jlogits, _ = jax.jit(lambda p: model.forward(
        p, jcfg, {"tokens": jb["tokens"]}))(jp)
    return (float(jl), np.asarray(jlogits),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(
                jax.device_get(jg))])


def check_train(run, name, mesh_shape=MESH):
    """Every rank's train step of ``TRAIN[name]`` against the JAX single
    device: logits, loss, every gradient block."""
    arch, mra, _ = TRAIN[name]
    jl, jlogits, jgrads = _jax_step(_jcfg(arch, mra), run["weights"][name],
                                    run["batches"][name])
    tcfg = get_smoke_config(arch, **_ov(mra))
    for rank, res in enumerate(run["got"]):
        got = res[f"train_step:{name}"]
        mesh = _mesh(rank, mesh_shape)
        rows = local_block(torch.from_numpy(np.array(jlogits)),
                           ("data", None, None), mesh).numpy()
        assert np.abs(got["logits"] - rows).max() < TOL["logits"]
        assert abs(got["loss"] - jl) < TOL["loss"]
        pl = tree_leaves_pspec(param_placements(tcfg, mesh))
        want = [local_block(torch.from_numpy(np.array(w)), ps, mesh).numpy()
                for w, ps in zip(jgrads, pl)]
        assert len(got["grads"]) == len(want)
        for g, w in zip(got["grads"], want):
            assert g.shape == w.shape
            assert np.abs(g - w).max() < TOL["grads"]
        assert np.isfinite(got["metrics"]["grad_norm"])


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_jax(run, name):
    check_train(run, name)


def test_train_splits_the_heads_and_keeps_the_rglru_whole(run):
    """rwkv6's time-mix heads and channel-mix d_ff, recurrentgemma's MLP
    and vocab are the rank's blocks; the RG-LRU weights whole."""
    for name, (arch, mra, _) in TRAIN.items():
        tcfg = get_smoke_config(arch, **_ov(mra))
        full = [w.shape for w in jax.tree_util.tree_leaves(
            run["weights"][name])]
        got = [p.shape for p in run["got"][0][f"train_step:{name}"]["params"]]
        tp = init_params(tcfg, seed=0, device="cpu")
        paths = [p for p, _ in _port_paths(tp)]
        shapes = dict(zip(paths, zip(got, [tuple(t.shape) for t in
                                           tree_leaves(tp)])))
        if arch == RWKV:
            local, whole = shapes[("layers", "0", "tm", "wr")]
            assert local[1] * MESH[1] == whole[1]
            local, whole = shapes[("layers", "0", "cm", "wv")]
            assert local[0] * MESH[1] == whole[0]
        else:
            for key in ("wx", "wa", "wo"):
                local, whole = shapes[("layers", "0", "rglru", key)]
                assert local == whole
            local, whole = shapes[("layers", "0", "mlp", "wi")]
            assert local[1] * MESH[1] == whole[1]
        assert len(got) == len(full)


def _port_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _port_paths(v, path + (str(i),))]
    return [(path, tree)]


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def _jax_serve(arch, jp):
    """The reference's prefill_chunk / decode_step on the whole batch: the
    logits and the cache after every call."""
    jcfg = _jcfg(arch)
    model = jax_get_model(jcfg)
    chunks, steps = _serve_inputs(jcfg.vocab)
    cache = jax_init(model.cache_specs(jcfg, SERVE["slots"],
                                       SERVE["max_len"]),
                     jax.random.PRNGKey(1))
    pre = jax.jit(lambda p, c, t, n: model.prefill_chunk(p, jcfg, c, t, n))
    dec = jax.jit(lambda p, c, t, a: model.decode_step(p, jcfg, c, t,
                                                       active=a))
    logits, caches = [], []
    fresh = cache
    for t, nv in chunks:
        lg, cache = pre(jp, cache, jnp.asarray(t, jnp.int32), jnp.asarray(nv))
        logits.append(np.asarray(lg))
        caches.append(jax.device_get(cache))
    for t, a in steps:
        lg, cache = dec(jp, cache, jnp.asarray(t, jnp.int32), jnp.asarray(a))
        logits.append(np.asarray(lg))
        caches.append(jax.device_get(cache))
    lg, cache = jax.jit(lambda p, b, c: model.prefill(p, jcfg, b, c))(
        jp, {"tokens": jnp.asarray(_prompt(jcfg.vocab), jnp.int32)}, fresh)
    return logits, caches, (np.asarray(lg), jax.device_get(cache))


@pytest.fixture(scope="module")
def serve_ref(run):
    return {arch: _jax_serve(arch, run["weights"][name])
            for arch, name in SERVED}


def _live(i):
    """(B,) the slots call ``i`` advanced (a chunk's ``num_valid > 0`` or a
    step's active mask)."""
    if i < len(CHUNK_NV):
        return np.array(CHUNK_NV[i]) > 0
    return np.array(STEP_ACTIVE[i - len(CHUNK_NV)])


def _blocks(arch, mesh, tree):
    """The rank's block of every leaf of a whole cache tree."""
    cfg = get_smoke_config(arch, **_ov())
    specs = get_model(cfg).cache_specs(cfg, SERVE["slots"], SERVE["max_len"])
    return {k: local_block(torch.from_numpy(np.array(tree[k])),
                           logical_to_pspec(s.shape, s.axes, mesh), mesh).numpy()
            for k, s in specs.items()}


def _cache_match(got, want, label):
    """A rank's cache block against the reference's block: float leaves
    within TOL["cache"], integer leaves exact."""
    assert set(got) == set(want)
    for key, a in got.items():
        assert a.shape == want[key].shape, (label, key)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, want[key], err_msg=key)
        else:
            assert np.abs(a.astype(np.float64) - want[key]).max() \
                < TOL["cache"], (label, key)


def check_serve(run, arch, ref, mesh_shape=MESH):
    """Every rank's serving calls against the reference's ``ref`` (logits
    and caches after each call, then the whole-prompt prefill's,
    ``_jax_serve``)."""
    want_logits, want_caches, (want_pl, want_pc) = ref
    for rank, res in enumerate(run["got"]):
        got = res[f"state_serve:{arch}"]
        for i, (g, w) in enumerate(zip(got["logits"], want_logits)):
            assert g.shape == w.shape  # every slot, the whole vocab
            live = _live(i)
            assert np.abs(g - w).max(-1)[live].max() < TOL["logits"], i
        mesh = _mesh(rank, mesh_shape)
        for i, (gc, wc) in enumerate(zip(got["cache"], want_caches)):
            _cache_match(gc, _blocks(arch, mesh, wc), i)
        assert np.array_equal(got["lengths"], want_caches[-1]["lengths"])
        pl, pc = got["prefill"]
        assert np.abs(pl - want_pl).max() < TOL["logits"]
        _cache_match(pc, _blocks(arch, mesh, want_pc), "prefill")


@pytest.mark.parametrize("arch", [RWKV, RGEMMA])
def test_chunked_prefill_and_decode_match_jax(run, serve_ref, arch):
    check_serve(run, arch, serve_ref[arch])


def check_frozen(run, arch, mesh_shape=MESH):
    """A slot a call does not advance keeps every leaf of the rank's block
    bit for bit (each rank holds its data rank's slots)."""
    n = SERVE["slots"] // mesh_shape[0]
    frozen_seen = 0
    for rank, res in enumerate(run["got"]):
        caches = res[f"state_serve:{arch}"]["cache"]
        i0 = _mesh(rank, mesh_shape).index("data") * n
        rows = slice(i0, i0 + n)
        for i in range(1, len(caches)):
            for j, live in enumerate(_live(i)[rows]):
                if live:
                    continue
                frozen_seen += 1
                for key, a in caches[i].items():
                    b = caches[i - 1][key]
                    sl = (j,) if key == "lengths" else (slice(None), j)
                    assert np.asarray(a[sl]).tobytes() == \
                        np.asarray(b[sl]).tobytes(), (i, key)
    assert frozen_seen > 0


@pytest.mark.parametrize("arch", [RWKV, RGEMMA])
def test_frozen_slots_stay_bit_identical(run, arch):
    check_frozen(run, arch)


def test_recurrentgemma_ring_wraps(run, serve_ref):
    """Slot 0 holds 48 + decoded tokens in a 32-entry ring: its positions
    past the window overwrote the oldest entries."""
    _, want_caches, _ = serve_ref[RGEMMA]
    pos = want_caches[-1]["kv_pos"]
    assert int(want_caches[-1]["lengths"][0]) > SERVE["max_len"] // 2
    assert pos.shape[-1] == 32 and int(pos[:, 0].max()) >= 32
    for rank, res in enumerate(run["got"]):
        if _mesh(rank).index("data") == 0:
            got = res[f"state_serve:{RGEMMA}"]["cache"][-1]["kv_pos"]
            assert int(got[:, 0].max()) >= 32


@pytest.mark.parametrize("arch", [RWKV, RGEMMA])
def test_state_cache_shapes_are_the_local_blocks(run, arch):
    cfg = get_smoke_config(arch, **_ov())
    specs = get_model(cfg).cache_specs(cfg, SERVE["slots"], SERVE["max_len"])
    for rank, res in enumerate(run["got"]):
        got = res[f"state_serve:{arch}"]
        mesh = _mesh(rank)
        assert got["type"] == ("RecurrentStateCache" if arch == RWKV
                               else "HybridWindowCache")
        for key, s in specs.items():
            want = local_shape(s.shape, logical_to_pspec(s.shape, s.axes,
                                                         mesh), mesh)
            assert got["shapes"][key] == want, key
        assert got["shapes"]["lengths"] == (SERVE["slots"] // MESH[0],)
    if arch == RWKV:  # the wkv state's heads split over "model"
        H = cfg.d_model // cfg.rwkv_head_dim
        assert run["got"][0][f"state_serve:{arch}"]["shapes"]["state"][2] \
            == H // MESH[1]


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
def _engine_streams(eng, req_cls, mix, sampling_cls):
    done = eng.run([req_cls(prompt=m[0], max_new_tokens=m[1],
                            sampling=sampling_cls(**m[2]) if len(m) > 2
                            else None) for m in mix])
    return {len(r.prompt): np.asarray(r.out) for r in done}


def check_engine(run, arch, name):
    """Every rank's mesh engine streams: the greedy ones equal the JAX
    single-device engine's, the sampled one the port's own one-device
    stream (the two packages' samplers draw differently)."""
    from repro.serve import SamplingParams as JSampling

    jcfg = _jcfg(arch)
    jp = run["weights"][name]
    mix = _dp_tp_requests(jcfg.vocab)
    jeng = JEngine(jcfg, jp, JEngineConfig(**ENGINE))
    want = _engine_streams(jeng, JRequest, mix, JSampling)
    tcfg = get_smoke_config(arch, **_ov())
    teng = Engine(tcfg, params_from_jax(jp, tcfg, device="cpu"),
                  EngineConfig(**ENGINE), device="cpu")
    own = _engine_streams(teng, Request, mix, SamplingParams)
    sampled = {len(m[0]) for m in mix if len(m) > 2}
    for res in run["got"]:
        got = res[f"engine:{arch}"]["streams"]
        assert set(got) == set(want)
        for plen in want:
            ref = own if plen in sampled else want
            np.testing.assert_array_equal(got[plen], ref[plen],
                                          err_msg=f"prompt length {plen}")
    for plen in want:
        if plen not in sampled:
            np.testing.assert_array_equal(own[plen], want[plen])


@pytest.mark.parametrize("arch,name", SERVED)
def test_mesh_engine_streams(run, arch, name):
    check_engine(run, arch, name)


# --------------------------------------------------------------------------- #
# elastic restore
# --------------------------------------------------------------------------- #
def test_rwkv6_checkpoint_saved_on_2x2_restores_on_1x4(run):
    from repro_torch.checkpoint import restore

    tcfg = get_smoke_config(RWKV, **_ov())
    seq, gb = ELASTIC["shape"]
    seen = {}
    tc = TrainConfig(steps=ELASTIC["steps"], warmup=1, lr=1e-3, log_every=100)
    train(tcfg, ShapeCfg(seq, gb), tc, device="cpu",
          on_metrics=lambda s, m: seen.__setitem__(s, m))
    like = init_params(tcfg, seed=1, device="cpu")
    whole = [t.numpy() for t in tree_leaves(
        restore(run["ckpt"], ELASTIC["steps"] - 1, like))]
    for rank, res in enumerate(run["got"]):
        got = res["elastic"]
        mesh = _mesh(rank, ELASTIC["mesh_b"])
        pl = tree_leaves_pspec(param_placements(tcfg, mesh))
        for g, w, ps in zip(got["restored"], whole, pl):
            assert np.array_equal(g, local_block(torch.from_numpy(w), ps,
                                                 mesh).numpy())
        for s in range(ELASTIC["steps"] - 1):
            assert abs(got["metrics"]["a"][s]["loss"] - seen[s]["loss"]) < 1e-4
        last = ELASTIC["steps"] - 1
        assert set(got["metrics"]["b"]) == {last}
        for key in ("loss", "grad_norm"):
            assert abs(got["metrics"]["b"][last][key] - seen[last][key]) \
                < 1e-4 * max(1.0, abs(seen[last][key]))


def test_data_mean_keeps_every_all_reduce_within_a_bucket(run):
    """The gradients' mean over "data" in place, a tensor larger than a
    bucket in pieces of its storage: 25 + 4 + 3 + 12 entries in 10-entry
    buckets make five all-reduces (10, 10, 5 + 4, 3, 12: a tensor that is
    not contiguous goes whole), and every entry is the mean of the data
    ranks' (1x and 2x its arange)."""
    for res in run["got"]:
        got = res["data_mean"]
        assert got["same"] and got["calls"] == 5
        want = [np.arange(float(n)) * 1.5 for n in DATA_MEAN["sizes"]]
        want.append((np.arange(12.0).reshape(3, 4) * 1.5).T)
        for g, w in zip(got["values"], want):
            np.testing.assert_array_equal(g, w)
