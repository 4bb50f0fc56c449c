"""Port parity on a (data, model) = (2, 2) mesh: serving.

Four gloo ranks on the CPU, spawned once for the file (see
test_torch_dist_train.py; the ranks run ``torch_dist_ranks.run_cases``,
which imports no JAX), against references computed here on the same numpy
inputs, at the reference's shard-tier tolerances
(tests/test_shard_parity.py, the ``shard``-marked cases of
tests/test_engine.py):

  * chunk and decode attention over each rank's (batch, kv-head) block of
    the decode state, a ring page table and int8 scales riding along, in
    both kernel modes: 1e-5 against the same block of the one-device call;
  * ``decode_step`` (5 steps) and two ragged ``prefill_chunk`` calls over
    the sharded cache: every slot's logits 5e-4 against the JAX single
    device, the cache blocks 5e-4, the lengths exact;
  * the mesh ``Engine`` and its ``spec_k=3`` speculative engine: greedy
    streams, speculative counters and accepted drafts identical to the JAX
    engine's, on every rank; and the kimi-k2 smoke MoE (8 experts, 4 a
    model rank: the expert-parallel dispatch) served the same way, with a
    capacity that drops nothing (each data rank sizes it from its own rows,
    as the reference does).
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
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.models.params import init_params as jax_build
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.core.attention import (
    AttentionSpec,
    chunk_attention,
    decode_attention,
)
from repro_torch.core.mra_decode import quantize_kv
from repro_torch.distributed.sharding import (
    attention_pspec,
    local_block,
    logical_to_pspec,
)
from repro_torch.launch.mesh import spawn
from test_torch_dist_train import DuckMesh
from test_torch_engine import _greedy_mix, _run

MESH = (2, 2)
ARCH = "qwen3-1.7b"
KV = dict(B=4, Hq=4, Hkv=2, S=64, D=8, b=16, C=8, m=2)
SERVE = dict(slots=4, max_len=64, steps=5, C=8)
ENGINE = dict(slots=4, max_len=64, chunk=8)
MOE_ARCH = "kimi-k2-1t-a32b"
SPEC_KEYS = ("spec_rounds", "spec_drafted_tokens", "spec_accepted_tokens",
             "spec_emitted_tokens", "draft_dispatches", "verify_dispatches",
             "decode_dispatches", "prefill_dispatches", "generated_tokens")


def _mesh(rank):
    return DuckMesh({"data": MESH[0], "model": MESH[1]}, rank)


def _kv_inputs():
    a = KV
    r = np.random.default_rng(0)
    B, Hkv, S, D, C = a["B"], a["Hkv"], a["S"], a["D"], a["C"]
    nb = S // a["b"]
    k = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, S, D)).astype(np.float32)
    q = r.standard_normal((B, a["Hq"], C, D)).astype(np.float32)
    q1 = r.standard_normal((B, a["Hq"], 1, D)).astype(np.float32)
    lengths = np.array([37, 64, 20, 55], np.int32)
    q_pos = (np.maximum(lengths[:, None] - C, 0) + np.arange(C)).astype(
        np.int32)
    # ring layout for two slots: 1.5x-capacity streams
    lengths_ring = np.array([96, 96, 20, 55], np.int32)
    pb = np.broadcast_to(np.arange(nb, dtype=np.int32)[None], (B, nb)).copy()
    pb[:2] = np.roll(pb[:2] + nb // 2, nb // 2, axis=1)
    kq, ks = (x.numpy() for x in quantize_kv(torch.from_numpy(k)))
    vq, vs = (x.numpy() for x in quantize_kv(torch.from_numpy(v)))
    return dict(k=k, v=v, q=q, q1=q1, lengths=lengths, q_pos=q_pos,
                lengths_ring=lengths_ring, pb=pb, kq=kq, ks=ks, vq=vq, vs=vs)


def _kv_ref(x):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    out = {}
    for mode in ("latency", "throughput"):
        spec = AttentionSpec(kind="mra2", block_size=KV["b"],
                             decode_blocks=KV["m"], kernel_mode=mode)
        c = chunk_attention(t["q"], t["k"], t["v"], t["lengths"], t["q_pos"],
                            spec)
        d = decode_attention(t["q1"], t["kq"], t["vq"], t["lengths_ring"],
                             spec, page_blocks=t["pb"], k_scale=t["ks"],
                             v_scale=t["vs"])
        out[mode] = (c.numpy(), d.numpy())
    return out


def _serve_inputs(vocab):
    r = np.random.default_rng(0)
    B, C = SERVE["slots"], SERVE["C"]
    steps = r.integers(0, vocab, (SERVE["steps"], B)).astype(np.int64)
    toks = r.integers(0, vocab, (B, 2 * C)).astype(np.int64)
    nv1 = np.array([8, 3, 8, 0], np.int32)  # ragged chunk 1
    nv2 = np.array([5, 8, 0, 7], np.int32)  # ragged chunk 2
    return steps, [(toks[:, :C], nv1), (toks[:, C:], nv2)]


def _serve_ref(jcfg, jp, steps, chunks):
    model = jax_get_model(jcfg)
    B, ml = SERVE["slots"], SERVE["max_len"]
    specs = model.cache_specs(jcfg, B, ml)
    cache = jax_build(specs, jax.random.PRNGKey(0))
    dec = jax.jit(lambda p, c, t: model.decode_step(p, jcfg, c, t))
    out = {"decode": []}
    for t in steps:
        logits, cache = dec(jp, cache, jnp.asarray(t, jnp.int32))
        out["decode"].append(np.asarray(logits))
    cache = jax_build(specs, jax.random.PRNGKey(0))
    pre = jax.jit(lambda p, c, t, n: model.prefill_chunk(p, jcfg, c, t, n))
    out["chunk"] = []
    for t, nv in chunks:
        logits, cache = pre(jp, cache, jnp.asarray(t, jnp.int32),
                            jnp.asarray(nv))
        out["chunk"].append(np.asarray(logits))
    out["cache"] = jax.device_get(cache)
    return out, specs


@pytest.fixture(scope="module")
def run():
    jcfg = jax_smoke(ARCH, activ_dtype="float32")
    jp = jax_init(jax_get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(0))
    weights = jax.device_get(jp)
    kv = _kv_inputs()
    steps, chunks = _serve_inputs(jcfg.vocab)
    mix = _greedy_mix()
    ov = {"activ_dtype": "float32"}
    cases = [
        ("kv_routes", dict(mesh_shape=MESH, block_size=KV["b"],
                           decode_blocks=KV["m"], **kv)),
        ("serve", dict(mesh_shape=MESH, arch=ARCH, overrides=ov,
                       weights=weights, steps_tokens=steps, chunks=chunks,
                       slots=SERVE["slots"], max_len=SERVE["max_len"])),
        ("engine:plain", dict(mesh_shape=MESH, arch=ARCH, overrides=ov,
                              weights=weights, mix=mix, spec_k=0, **ENGINE)),
        ("engine:spec", dict(mesh_shape=MESH, arch=ARCH, overrides=ov,
                             weights=weights, mix=mix, spec_k=3, **ENGINE)),
    ]
    mcfg = _moe_jax_cfg()
    mp = jax_init(jax_get_model(mcfg).param_specs(mcfg), jax.random.PRNGKey(1))
    cases.append(("engine:moe", dict(
        mesh_shape=MESH, arch=MOE_ARCH, weights=jax.device_get(mp), mix=mix,
        spec_k=0, overrides={"activ_dtype": "float32",
                             "moe": _no_drop(get_smoke_config(
                                 MOE_ARCH).moe)}, **ENGINE)))
    got = spawn(R.run_cases, 4, cases, device="cpu", threads=1)
    return {"got": got, "jcfg": jcfg, "jp": jp, "kv": kv, "steps": steps,
            "chunks": chunks, "mix": mix, "mcfg": mcfg, "mp": mp}


def _no_drop(moe):
    return dataclasses.replace(moe,
                               capacity_factor=moe.num_experts / moe.top_k)


def _moe_jax_cfg():
    cfg = jax_smoke(MOE_ARCH, activ_dtype="float32")
    return cfg.replace(moe=_no_drop(cfg.moe))


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_decode_and_chunk_routes_match_one_device(run, mode):
    want_c, want_d = _kv_ref(run["kv"])[mode]
    for rank, res in enumerate(run["got"]):
        got = res["kv_routes"]
        assert got["parts"] == ("data", "model")
        blk = lambda a: local_block(  # noqa: E731
            torch.from_numpy(a), attention_pspec(got["parts"], a.ndim),
            _mesh(rank)).numpy()
        c, d = got["out"][mode]
        assert np.abs(c - blk(want_c)).max() < 1e-5
        assert np.abs(d - blk(want_d)).max() < 1e-5


@pytest.fixture(scope="module")
def serve_ref(run):
    return _serve_ref(run["jcfg"], run["jp"], run["steps"], run["chunks"])


def test_decode_steps_match_jax(run, serve_ref):
    want, _ = serve_ref
    for res in run["got"]:
        for got, w in zip(res["serve"]["decode"], want["decode"]):
            assert got.shape == w.shape  # every slot, the whole vocab
            assert np.abs(got - w).max() < 5e-4


def test_chunked_prefill_matches_jax(run, serve_ref):
    want, specs = serve_ref
    nvs = [nv for _, nv in run["chunks"]]
    for rank, res in enumerate(run["got"]):
        got = res["serve"]
        for g, w, nv in zip(got["chunk"], want["chunk"], nvs):
            act = nv > 0
            assert np.abs(g - w).max(-1)[act].max() < 5e-4
        assert np.array_equal(got["lengths"], nvs[0] + nvs[1])
        mesh = _mesh(rank)
        for key, tree in got["cache"].items():
            wl = want["cache"][key]
            sl = specs[key]
            for i, a in enumerate(tree if isinstance(tree, list) else [tree]):
                w = np.asarray(wl[i] if isinstance(tree, list) else wl)
                s = sl[i] if isinstance(tree, list) else sl
                ps = logical_to_pspec(s.shape, s.axes, mesh)
                ps = tuple(None if p == "data" and j > 0 else p
                           for j, p in enumerate(ps))  # kv_seq kept whole
                wb = local_block(torch.from_numpy(w), ps, mesh).numpy()
                assert a.shape == wb.shape, key
                assert np.abs(a.astype(np.float64) - wb).max() < 5e-4, key


@pytest.fixture(scope="module")
def jax_engines(run):
    out = {}
    for name, k, cfg, p in (("engine:plain", 0, run["jcfg"], run["jp"]),
                            ("engine:spec", 3, run["jcfg"], run["jp"]),
                            ("engine:moe", 0, run["mcfg"], run["mp"])):
        eng = JEngine(cfg, p, JEngineConfig(spec_k=k, **ENGINE))
        out[name] = (_run(JEngine, JRequest, eng, run["mix"]),
                     {key: eng.stats[key] for key in SPEC_KEYS})
    return out


@pytest.mark.parametrize("name", ["engine:plain", "engine:spec",
                                  "engine:moe"])
def test_mesh_engine_streams_match_jax_engine(run, jax_engines, name):
    streams, stats = jax_engines[name]
    for res in run["got"]:
        got = res[name]
        assert set(got["streams"]) == set(streams)
        for plen in streams:
            np.testing.assert_array_equal(got["streams"][plen], streams[plen],
                                          err_msg=f"prompt length {plen}")
        assert got["stats"] == stats
    if name == "engine:spec":
        assert 0 < stats["spec_accepted_tokens"] < stats["spec_drafted_tokens"]
