"""The (data, model) = (2, 4) mirror of the reference's shard tier, on the
port: eight gloo ranks on the CPU, spawned once for the file.

Marked ``shard``: ``pytest.ini`` deselects it by default; run it with

    PYTHONPATH=src python -m pytest -q -m shard tests/test_torch_dist_shard.py

The cases and tolerances are those of tests/test_shard_parity.py and
tests/test_dist_cpu.py (and the tier-1 (2, 2) files,
test_torch_dist_train.py / test_torch_dist_serve.py, whose helpers run
here): MRA-2 attention on 8 query / 4 KV heads, the qwen3-1.7b smoke model
with 8 / 4 heads of 8 (every head split over the model axis) and at its own
4 / 2 heads (the query heads split, the KV heads not: the attention
weights are gathered and attention runs replicated), the decode and chunk
routes, the serve step and chunked prefill, the mesh engine plain and
speculative, and the expert-parallel MoE of the kimi-k2 smoke config (8
experts, 2 a model rank).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import get_model as jax_get_model
from repro.models import init_params as jax_init
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import attention_pspec, local_block
from repro_torch.launch.mesh import spawn
from repro_torch.models.moe import moe_block
from test_torch_dist_serve import SPEC_KEYS, _kv_inputs, _kv_ref, _serve_inputs
from test_torch_dist_serve import _serve_ref
from test_torch_dist_train import (
    DuckMesh,
    _attention_ref,
    _check_step,
    _jax_step,
    _moe_inputs,
)
from test_torch_engine import _greedy_mix, _run
from test_torch_train import _kernel_route, _shapes

pytestmark = pytest.mark.shard

MESH = (2, 4)
ARCH = "qwen3-1.7b"
HEADS = {"split": dict(num_heads=8, kv_heads=4, head_dim=8),
         "q_only": {}}
ENGINE = dict(slots=4, max_len=64, chunk=8)


def _mesh(rank):
    return DuckMesh({"data": MESH[0], "model": MESH[1]}, rank)


def _ov(heads):
    return {"activ_dtype": "float32", **HEADS[heads]}


def _jax_cfg(heads, kernel):
    kw = dict(_ov(heads))
    if kernel:
        kw.update(attn_use_kernel=True, attn_kernel_bwd="jnp")
    return jax_smoke(ARCH, **kw)


def _moe_ov():
    base = get_smoke_config("kimi-k2-1t-a32b", activ_dtype="float32")
    return {"activ_dtype": "float32", "moe": dataclasses.replace(
        base.moe, capacity_factor=base.moe.num_experts / base.moe.top_k)}


@pytest.fixture(scope="module")
def run():
    r = np.random.default_rng(0)
    B, Hq, Hkv, N, D = 4, 8, 4, 96, 16
    q = r.standard_normal((B, Hq, N, D)).astype(np.float32)
    k = r.standard_normal((B, Hkv, N, D)).astype(np.float32)
    v = r.standard_normal((B, Hkv, N, D)).astype(np.float32)
    masks = [np.ones((B, N), bool), r.random((B, N)) > 0.25]
    kv = _kv_inputs()
    kv = {**kv, "q": np.concatenate([kv["q"]] * 2, 1),
          "q1": np.concatenate([kv["q1"]] * 2, 1),
          **{x: np.concatenate([kv[x]] * 2, 1)
             for x in ("k", "v", "kq", "vq", "ks", "vs")}}
    jcfgs = {h: _jax_cfg(h, True) for h in HEADS}
    weights = {h: jax.device_get(jax_init(jax_get_model(c).param_specs(c),
                                          jax.random.PRNGKey(0)))
               for h, c in jcfgs.items()}
    jshape, _ = _shapes(batch=4)
    batch = jax_make_batch(jcfgs["split"], jshape, step=1, seed=3)
    steps, chunks = _serve_inputs(512)
    mcfg = get_smoke_config("kimi-k2-1t-a32b", **_moe_ov())
    mw, mx = _moe_inputs(mcfg)
    cases = [
        ("attention", dict(mesh_shape=MESH, q=q, k=k, v=v, masks=masks,
                           block_size=16, blocks_per_row=3)),
        ("kv_routes", dict(mesh_shape=MESH, block_size=16, decode_blocks=2,
                           **kv)),
        *[(f"train_step:{h}", dict(mesh_shape=MESH, arch=ARCH,
                                   overrides=_ov(h), weights=weights[h],
                                   batch=batch, lr=1e-3)) for h in HEADS],
        *[(f"serve:{h}", dict(mesh_shape=MESH, arch=ARCH, overrides=_ov(h),
                              weights=weights[h], steps_tokens=steps,
                              chunks=chunks, slots=4, max_len=64))
          for h in HEADS],
        *[(f"engine:{h}:{kk}", dict(mesh_shape=MESH, arch=ARCH,
                                    overrides=_ov(h), weights=weights[h],
                                    mix=_greedy_mix(), spec_k=kk, **ENGINE))
          for h in HEADS for kk in (0, 3)],
        ("moe", dict(mesh_shape=MESH, arch="kimi-k2-1t-a32b",
                     overrides=_moe_ov(), weights=mw, x=mx)),
    ]
    got = spawn(R.run_cases, MESH[0] * MESH[1], cases, device="cpu",
                threads=1)
    return {"got": got, "attn": (q, k, v, masks), "kv": kv,
            "weights": weights, "batch": batch, "steps": steps,
            "chunks": chunks, "moe": (mcfg, mw, mx)}


def test_attention_blocks(run):
    want = _attention_ref(*run["attn"])
    for rank, res in enumerate(run["got"]):
        got = res["attention"]
        assert got["parts"] == ("data", "model")
        for (o, grads), (wo, wg) in zip(got["out"], want):
            blk = lambda a: local_block(  # noqa: E731
                torch.from_numpy(a), attention_pspec(got["parts"], a.ndim),
                _mesh(rank)).numpy()
            assert np.abs(o - blk(wo)).max() < 1e-5
            assert max(np.abs(g - blk(w)).max()
                       for g, w in zip(grads, wg)) < 1e-4


def test_decode_and_chunk_routes(run):
    want = _kv_ref(run["kv"])
    for rank, res in enumerate(run["got"]):
        got = res["kv_routes"]
        for mode, (wc, wd) in want.items():
            c, d = got["out"][mode]
            blk = lambda a: local_block(  # noqa: E731
                torch.from_numpy(a), attention_pspec(got["parts"], a.ndim),
                _mesh(rank)).numpy()
            assert np.abs(c - blk(wc)).max() < 1e-5
            assert np.abs(d - blk(wd)).max() < 1e-5


@pytest.mark.parametrize("heads", list(HEADS))
def test_train_step(run, heads):
    jcfg = _jax_cfg(heads, True)
    _check_step(run["got"], f"train_step:{heads}",
                get_smoke_config(ARCH, **_ov(heads)),
                _jax_step(jcfg, run["weights"][heads], run["batch"]),
                mesh_of=_mesh)


@pytest.mark.parametrize("heads", list(HEADS))
def test_serve_step_and_chunked_prefill(run, heads):
    with _kernel_route():
        want, _ = _serve_ref(_jax_cfg(heads, False), run["weights"][heads],
                             run["steps"], run["chunks"])
    for res in run["got"]:
        got = res[f"serve:{heads}"]
        for g, w in zip(got["decode"], want["decode"]):
            assert np.abs(g - w).max() < 5e-4
        for g, w, (_, nv) in zip(got["chunk"], want["chunk"], run["chunks"]):
            assert np.abs(g - w).max(-1)[nv > 0].max() < 5e-4


@pytest.mark.parametrize("heads", list(HEADS))
def test_engine_streams(run, heads):
    jcfg = _jax_cfg(heads, False)
    for kk in (0, 3):
        eng = JEngine(jcfg, run["weights"][heads],
                      JEngineConfig(spec_k=kk, **ENGINE))
        streams = _run(JEngine, JRequest, eng, _greedy_mix())
        stats = {key: eng.stats[key] for key in SPEC_KEYS}
        for res in run["got"]:
            got = res[f"engine:{heads}:{kk}"]
            for plen in streams:
                np.testing.assert_array_equal(got["streams"][plen],
                                              streams[plen])
            assert got["stats"] == stats


def test_moe_expert_parallel(run):
    cfg, w, x = run["moe"]
    out, _ = moe_block(torch.from_numpy(x),
                       {k: torch.from_numpy(v) for k, v in w.items()}, cfg)
    for rank, res in enumerate(run["got"]):
        rows = local_block(out, ("data", None, None), _mesh(rank)).numpy()
        assert np.abs(res["moe"]["out"] - rows).max() < 1e-3
