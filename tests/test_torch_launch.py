"""The port's launch tools against the reference's, on the CPU.

* the shape cells (``configs.SHAPES``) and ``shape_skips`` equal the
  reference's;
* ``launch/dryrun.py::model_flops`` equals the reference's for all 40 arch x
  shape cells, and the per-rank parameter bytes of ``launch/specs.py`` equal
  the reference's per-device bytes (``NamedSharding.shard_shape`` over its
  abstract parameters) for every arch at full width on (2, 4) and (16, 16);
* the dry run of the dense smoke train cell (full attention, no remat,
  B = 4, S = 64, one device) counts exactly the matmul FLOPs the reference's
  ``hlo_profile.dot_flops_by_op`` counts in its compiled step;
* an ``AbstractMesh`` (2, 2) records the collective bytes a real gloo (2, 2)
  run of the same smoke step moves on rank 0;
* ``kernels/cost.py`` gives PERF.md §6's bound figures at the table's
  shapes; the kernel wrappers' meta route records their calls, and a shape
  no kernel is built for lands in ``kernels_unbuilt``;
* ``dryrun`` and ``roofline`` run their CLIs on a few cells.

The reference's dry-run code runs in a subprocess (its module sets
``XLA_FLAGS`` at import, which must not reach this process).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import shape_skips as j_shape_skips
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_skips
from repro_torch.distributed.sharding import local_shape, param_placements
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels import chunk_attn, cost
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch.specs import params_abstract, tree_bytes

ROOT = Path(__file__).resolve().parents[1]
SMOKE = dict(smoke=True, attention_override={"kind": "full"},
             config_override={"remat": "none"}, batch=4, seq=64)
SMOKE_DOTS = 188_743_680  # the reference's dot count of that step


def _reference(code: str) -> dict:
    """Run ``code`` (which prints one JSON object last) in a fresh process
    with the reference on the path and 256 host devices."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=256")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


REF_COUNTS = """
import json, math
import jax
from repro.configs import ARCHS, SHAPES, get_config
from repro.launch import dryrun as rd
from repro.launch.mesh import _make_mesh
from repro.launch.specs import params_abstract
out = {"model_flops": {f"{a}|{s}": rd.model_flops(get_config(a), SHAPES[s])
                       for a in ARCHS for s in SHAPES}, "param_bytes": {}}
for shape in ((2, 4), (16, 16)):
    mesh = _make_mesh(shape, ("data", "model"))
    for a in ARCHS:
        p = params_abstract(get_config(a), mesh)
        out["param_bytes"][f"{a}|{shape[0]}x{shape[1]}"] = sum(
            math.prod(l.sharding.shard_shape(l.shape)) * l.dtype.itemsize
            for l in jax.tree.leaves(p))
print(json.dumps(out))
"""

REF_DOTS = """
import dataclasses, json
import jax
from repro.configs import get_smoke_config
from repro.configs.base import ShapeCfg
from repro.distributed import mesh_utils
from repro.launch.hlo_profile import dot_flops_by_op
from repro.launch.mesh import make_local_mesh
from repro.launch.specs import batch_specs, params_abstract
from repro.optim import AdamW, cosine_schedule
from repro.train import TrainConfig, make_train_step
cfg = get_smoke_config("qwen3-1.7b")
cfg = cfg.replace(attention=dataclasses.replace(cfg.attention, kind="full"),
                  remat="none")
mesh = make_local_mesh(1, 1)
with mesh_utils.use_mesh(mesh):
    params = params_abstract(cfg, mesh)
    opt = AdamW()
    step = make_train_step(cfg, TrainConfig(microbatches=1), opt,
                           cosine_schedule(1e-4, 10, 1000))
    comp = jax.jit(step).lower(params, opt.abstract_state(params, mesh),
                               batch_specs(cfg, ShapeCfg("train", 64, 4, "train"),
                                           mesh)).compile()
print(json.dumps({"dots": dot_flops_by_op(comp.as_text())[0]}))
"""


@pytest.fixture(scope="module")
def ref_counts():
    return _reference(REF_COUNTS)


# --------------------------------------------------------------------------- #
# cells, model FLOPs, per-rank parameters
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(J_SHAPES))
def test_shape_cells_equal_the_reference(name):
    j, t = J_SHAPES[name], SHAPES[name]
    assert (t.name, t.seq_len, t.global_batch, t.kind) == (
        j.name, j.seq_len, j.global_batch, j.kind)
    assert list(SHAPES) == list(J_SHAPES) and set(ARCHS) == set(J_ARCHS)
    for arch in ARCHS:
        assert shape_skips(arch, name) == j_shape_skips(arch, name)


def test_positional_shapecfg_is_a_training_shape():
    s = dryrun.SHAPES["train_4k"]
    assert type(s)(4096, 256).seq_len == s.seq_len and type(s)(4096, 256).kind == "train"


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_rank_bytes_equal_the_reference(arch, ref_counts):
    for shape in SHAPES:
        assert dryrun.model_flops(get_config(arch), SHAPES[shape]) == \
            ref_counts["model_flops"][f"{arch}|{shape}"], shape
    for dims in ((2, 4), (16, 16)):
        got = tree_bytes(params_abstract(get_config(arch), AbstractMesh(*dims)))
        assert got == ref_counts["param_bytes"][f"{arch}|{dims[0]}x{dims[1]}"]


def test_abstract_mesh_serves_the_placements():
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.index("model") == 0 and mesh.size == 512
    cfg = get_config("qwen3-1.7b")
    pl = param_placements(cfg, make_production_mesh())
    wq = cfg.d_model, cfg.num_heads, cfg.hd
    assert local_shape(wq, pl["layers"][0]["attn"]["wq"],
                       make_production_mesh()) == (cfg.d_model, 1, cfg.hd)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("data")


# --------------------------------------------------------------------------- #
# the dry run's counts
# --------------------------------------------------------------------------- #
def test_dense_smoke_cell_counts_the_reference_dots():
    cell = dryrun.lower_cell("qwen3-1.7b", "train_4k", mesh=AbstractMesh(1, 1),
                             **SMOKE)
    assert cell["cost"]["matmul_flops_per_device"] == SMOKE_DOTS
    assert _reference(REF_DOTS)["dots"] == SMOKE_DOTS


def _gloo_rank(rank):
    """One smoke train step of the dense smoke cell on rank ``rank`` of a
    gloo (2, 2) mesh: the collective bytes it moved, by op and by axis."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data import make_batch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import batch_pspec, local_block
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.optim.adamw import zero_plan
    from repro_torch.train.loop import TrainConfig, make_train_step

    cfg = get_smoke_config("qwen3-1.7b")
    cfg = cfg.replace(attention=dataclasses.replace(cfg.attention,
                                                    kind="full"),
                      remat="none")
    mesh = make_local_mesh(2, 2, device="cpu")
    params = init_params(cfg, seed=0, device="cpu", mesh=mesh)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    plan = zero_plan(params, param_placements(cfg, mesh), mesh)
    opt = AdamW()
    step = make_train_step(cfg, TrainConfig(microbatches=1), opt,
                           cosine_schedule(1e-4, 10, 1000), mesh=mesh,
                           plan=plan)
    batch = {k: local_block(torch.from_numpy(v), batch_pspec(mesh, v.ndim),
                            mesh)
             for k, v in make_batch(cfg, ShapeCfg(64, 4)).items()}
    state = opt.init(params, plan)
    C.STATS.reset()
    step(params, state, batch)
    return ({op: v["bytes"] for op, v in C.STATS.snapshot()["ops"].items()},
            {f"{op}:{ax}": n for (op, ax), n in C.STATS.by_axis.items()})


def test_abstract_mesh_records_the_gloo_collectives():
    from repro_torch.launch.mesh import spawn

    ops, by_axis = spawn(_gloo_rank, 4, device="cpu", timeout=300,
                         threads=1)[0]
    cell = dryrun.lower_cell("qwen3-1.7b", "train_4k", mesh=AbstractMesh(2, 2),
                             **SMOKE)
    got = {k: v for k, v in cell["collectives"].items() if k != "count"}
    assert got == ops and ops
    assert cell["collectives_by_axis"] == by_axis


# --------------------------------------------------------------------------- #
# kernels/cost.py against PERF.md §6, the meta route
# --------------------------------------------------------------------------- #
# PERF.md §6 bytes-bound figures (ms): (kernel, BHG, BHKV, n, d, b, pairs a
# row) of rows 1-3: qwen3 B = 2 (128, 128) G = 2; granite (64, 128) G = 3;
# hubert (80, 128) non-causal; recurrentgemma (256, 128) G = 16; the
# H-Transformer-1D baseline (64, 32), three blocks a row
BSA_ROWS = [
    ("bsa_fwd", 32, 16, 4096, 128, 128, 128, 0.04047),
    ("bsa_bwd_dq", 32, 16, 4096, 128, 128, 128, 0.06050),
    ("bsa_fwd", 24, 8, 4096, 64, 128, 128, 0.01406),
    ("bsa_fwd", 32, 32, 4096, 80, 128, 128, 0.03179),
    ("bsa_bwd_dq", 32, 32, 4096, 80, 128, 128, 0.04431),
    ("bsa_bwd_dkv", 32, 32, 4096, 80, 128, 128, 0.05683),
    ("bsa_fwd", 32, 2, 4096, 256, 128, 128, 0.06294),
    ("bsa_bwd_dq", 32, 2, 4096, 256, 128, 128, 0.1030),
    ("bsa_fwd", 8, 8, 512, 64, 32, 48, 0.000799),
]


@pytest.mark.parametrize("row", BSA_ROWS, ids=lambda r: f"{r[0]}-d{r[4]}-b{r[5]}")
def test_cost_gives_the_perf_table_bounds(row):
    kernel, BHG, BHKV, n, d, b, m2, want = row
    c = cost.bsa_cost(kernel, BHG, BHKV, n, d, b, m2, 2, full=0)
    ms, by = cost.bound_ms(c["bytes"], 0.0)
    assert by == "bytes" and round(ms, 7) == pytest.approx(want, rel=1.5e-3)


def test_chunk_cost_counts_pages_means_and_output():
    c = cost.chunk_cost(B=1, Hkv=1, G=2, C=1, D=128, b=128, nb=4, elem=2,
                        quant=False, union=3, pairs=2 * 3 * 128)
    assert c["bytes"] == (2 * 3 * 128 * 128 * 2 + 2 * 4 * 128 * 4 + 2 * 4 * 4
                          + 2 * 128 * 4 + 4 + 2 * 128 * 4)
    assert c["flops"] == 4 * 2 * 4 * 128 + 4 * 768 * 128
    union, pairs = cost.chunk_budget(B=2, Hkv=8, G=2, C=1, b=128, nb=4096,
                                     m=16, c_tile=1)
    assert (union, pairs) == (2 * 8 * 32, 2 * 8 * 2 * 16 * 128)
    assert cost.bound_ms(3.35e12, 0.0) == (1e3, "bytes")


def test_meta_route_records_each_call_and_the_unbuilt_shapes():
    cost.LEDGER.reset()
    dev = torch.device("meta")
    q = torch.empty((4, 512, 128), device=dev, dtype=torch.bfloat16)
    k = torch.empty((2, 512, 128), device=dev, dtype=torch.bfloat16)
    idx = torch.empty((4, 16), device=dev, dtype=torch.int32)
    out, rs, mt, pairs = bsa._forward(q, k, k, torch.empty((4, 4), device=dev),
                                      idx, idx, idx, None, 0.1, 128)
    assert out.is_meta and tuple(rs.shape) == (4, 512) and pairs is None
    dq, dk, dv = bsa._backward(q, k, k, None, mt, None, idx, idx, idx, None,
                               out, rs, 0.1, 128)
    assert tuple(dk.shape) == (2, 512, 128) and dq.dtype == torch.float32
    q96 = torch.empty((4, 512, 96), device=dev)
    bsa._forward(q96, q96[:2], q96[:2], torch.empty((4, 4), device=dev),
                 idx, idx, idx, None, 0.1, 128)
    snap = cost.LEDGER.snapshot()
    assert {k: v["calls"] for k, v in snap["kernels"].items()} == {
        "bsa_fwd": 1, "bsa_bwd_dq": 1, "bsa_bwd_dkv": 1}
    assert snap["kernels"]["bsa_fwd"]["flops"] == 2 * 2 * 4 * 16 * 128 ** 3
    assert snap["kernels_unbuilt"] == ["bsa_fwd (96, 128)"]
    # at long_500k's 4096 pages qwen2-7b's G = 7 decode tile takes the
    # workspace program, qwen3-1.7b's G = 2 one still fits shared memory
    for arch, ws in (("qwen2-7b", True), ("qwen3-1.7b", False)):
        cell = dryrun.lower_cell(arch, "long_500k", mesh=AbstractMesh(1, 1),
                                 layers=1)
        key = next(iter(cell["kernels"]["chunk_attn"]["shapes"]))
        assert "nb=4096" in key and key.endswith("workspace") == ws
    assert chunk_attn.chunk_attention_kernel.launches == 0


def test_dryrun_and_roofline_clis(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                        "--single-pod-only", "--results-dir",
                        str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "long_500k",
                        "--multi-pod-only", "--results-dir",
                        str(tmp_path)]) == 0
    cells = roofline.load_cells(tmp_path)
    assert sorted(c["status"] for c in cells) == ["ok", "skipped"]
    ok = next(c for c in cells if c["status"] == "ok")
    assert ok["chips"] == 256 and ok["memory"]["peak_bytes"] >= \
        ok["memory"]["arguments"] > 0
    row = roofline.analyze(ok)
    assert row["fits_80g"] and row["dominant"] in ("compute", "memory",
                                                   "collective")
    roofline.main(["--markdown", "--results-dir", str(tmp_path),
                   "--json-out", str(tmp_path / "rows.json")])
    text = capsys.readouterr().out
    assert "| qwen3-1.7b | decode_32k | 16x16 |" in text
    assert "SKIPPED" in text
    assert json.loads((tmp_path / "rows.json").read_text())[0]["arch"] == \
        "qwen3-1.7b"


def test_axis_links_follow_the_node_layout():
    assert roofline.axis_links({"data": 2, "model": 4}) == {
        "model": cost.NVLINK_BYTES_PER_S, "data": cost.NVLINK_BYTES_PER_S}
    assert roofline.axis_links({"data": 16, "model": 16}) == {
        "model": cost.IB_BYTES_PER_S, "data": cost.IB_BYTES_PER_S}
    assert roofline.axis_links({"data": 4, "model": 8})["data"] == \
        cost.IB_BYTES_PER_S
