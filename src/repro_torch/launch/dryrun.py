"""Dry run: every (architecture x input shape x production mesh) cell on
the meta device, with its memory, operations and collective bytes a rank.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell's jitted step against its 256- and 512-chip meshes and reads XLA's
memory and cost analyses. Here rank 0 of the mesh (a
``launch.mesh.AbstractMesh``: no process group, no device) runs the
port's own step on tensors on the meta device (shapes and dtypes, no
storage, no arithmetic):

  * train: ``loss_fn``, its backward and the AdamW / ZeRO-1 update
    (``train.loop.make_train_step``, one microbatch); ``prefill``: the
    family's whole-prompt ``prefill`` into a cache of the shape's length;
    ``decode``: one ``decode_step`` over that cache;
  * every collective records its payload and returns an empty tensor of
    the result's local shape (``distributed/collectives.py``);
  * the kernel wrappers take their meta route: the card's shape check and
    plan, empty outputs, each call's operations and bytes at the selection
    budget (``kernels/cost.py``); a shape no kernel is built for lands in
    ``kernels_unbuilt``.

Per cell it records the argument bytes (parameters, optimizer moments,
batch, cache: exact), the peak of live bytes during the step (each
output storage counted from its creation until it is freed), the matmul
FLOPs (``torch.utils.flop_counter.FlopCounterMode``) and the kernels'
counts by kernel, the collective bytes by op (and by op and axis), the
reference's ``model_flops`` (6·N·D / 2·N·D, N active for MoE), the kernel
launch shapes, status and seconds. Train cells run unrolled at one and two
periods of layers and extrapolate linearly in depth, as the reference's
scanned cells do; the serving cells run at full depth.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only

Results: ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` (one a
cell; ``--force`` recomputes a cached ``ok`` / ``skipped`` cell);
``launch/roofline.py`` reads them. Nothing here needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (
    ARCHS,
    SHAPES,
    get_config,
    get_smoke_config,
    shape_skips,
)
from repro_torch.distributed import collectives, mesh_utils
from repro_torch.distributed.sharding import ShardingRules, param_placements
from repro_torch.kernels import cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    batch_specs,
    cache_abstract,
    decode_tokens_abstract,
    params_abstract,
    tree_bytes,
)
from repro_torch.models.params import param_specs, spec_paths
from repro_torch.models.registry import get_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.optim.adamw import AdamWState, zero_plan
from repro_torch.train.loop import TrainConfig, make_train_step

__all__ = ["LiveBytes", "OPT_ATTN_OVERRIDES_DECODE", "OPT_CONFIG",
           "OPT_OVERRIDES", "OPT_RULES", "RESULTS_DIR", "lower_cell", "main",
           "model_flops", "run_cell"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# the reference's optimized-variant overrides (applied with opt=True) where
# the port has the fields: TP head padding, int8 KV for the MRA decode
# cells, kimi-k2's weights over the data axes, a2a dispatch, bf16 weights
OPT_OVERRIDES = {
    "qwen2-7b": {"pad_attn_heads_to": 16},
    "llama3.2-3b": {"pad_attn_heads_to": 16},
    "internvl2-1b": {"pad_attn_heads_to": 16},
    "granite-moe-3b-a800m": {"pad_attn_heads_to": 16},
}
OPT_ATTN_OVERRIDES_DECODE = {"kv_quant": True}
OPT_RULES = {"kimi-k2-1t-a32b": {"d_model": (("data",),)}}
OPT_CONFIG = {"kimi-k2-1t-a32b": {"moe_dispatch": "a2a",
                                  "param_dtype": "bfloat16"}}


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill: D = B·S; decode: D = B), N the
    parameters, the experts' counted at top_k / num_experts (the
    reference's ``model_flops``)."""
    total = sum(math.prod(s.shape) for _, s in spec_paths(param_specs(cfg)))
    active = total
    if cfg.moe is not None:
        from repro_torch.models.moe import moe_specs

        expert = (sum(math.prod(s.shape) for _, s in spec_paths(moe_specs(cfg)))
                  - cfg.d_model * cfg.moe.num_experts)
        expert_total = expert * cfg.num_layers
        active = (total - expert_total
                  + expert_total * cfg.moe.top_k / cfg.moe.num_experts)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages alive, from each op output's creation to its
    release, and their peak. ``track`` registers tensors made before the
    mode (the arguments). A storage's release is seen at the next sweep,
    made before any allocation that could raise the peak."""

    def __init__(self):
        super().__init__()
        self.live: dict = {}  # storage key -> (weak ref, bytes)
        self.cur = self.peak = 0
        self.largest: dict = {}  # key -> (bytes, op, shape, dtype)
        self.at_peak, self.at_peak_bytes = [], 0
        self._ops = 0

    def track(self, t, op: str = "argument") -> None:
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        if self.cur + n > self.peak:
            self.sweep()
        self.live[key] = (StorageWeakRef(st), n)
        self.cur += n
        if n >= 1 << 20:
            self.largest[key] = (n, op, tuple(t.shape), str(t.dtype))
        if self.cur > self.peak:
            if self.cur > 1.01 * self.at_peak_bytes:  # the peak's tensors
                self.at_peak = sorted(self.largest.values(), reverse=True)[:10]
                self.at_peak_bytes = self.cur
            self.peak = self.cur

    def sweep(self) -> None:
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.largest.pop(key, None)
                self.cur -= n

    def top(self) -> list:
        """The ten largest storages alive at (within 1% of) the peak."""
        return [{"bytes": n, "op": op, "shape": list(s), "dtype": d}
                for n, op, s, d in self.at_peak]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self._ops += 1
        if self._ops % 512 == 0:
            self.sweep()
        for t in tree_flatten(out)[0]:
            self.track(t, str(func.overloadpacket.__name__))
        return out


def _config(arch, shape, opt, attention_override, config_override, layers,
            smoke=False):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    rules = None
    if opt and arch in OPT_OVERRIDES:
        cfg = cfg.replace(**OPT_OVERRIDES[arch])
    if opt and arch in OPT_CONFIG:
        cfg = cfg.replace(**OPT_CONFIG[arch])
    if opt and arch in OPT_RULES:
        rules = ShardingRules().override(**OPT_RULES[arch])
    if (opt and shape.kind == "decode"
            and cfg.attention.kind in ("mra2", "mra2_s")):
        attention_override = {**OPT_ATTN_OVERRIDES_DECODE,
                              **(attention_override or {})}
    if config_override:
        cfg = cfg.replace(**config_override)
    if attention_override:
        cfg = cfg.replace(attention=dataclasses.replace(
            cfg.attention, **attention_override))
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    return cfg, rules


def _train_args(cfg, shape, mesh, rules):
    params = params_abstract(cfg, mesh, rules)
    for p in tree_flatten(params)[0]:
        p.requires_grad_(True)
    plan = None
    if mesh is not None:
        plan = zero_plan(params, param_placements(cfg, mesh, rules), mesh,
                         rules)
    opt = AdamW()
    state = opt.init(params, plan)
    batch = batch_specs(cfg, shape, mesh)
    step = make_train_step(cfg, TrainConfig(microbatches=1), opt,
                           cosine_schedule(1e-4, 10, 1000), mesh=mesh,
                           plan=plan)
    return step, {"params": params, "optimizer": (state.mu, state.nu),
                  "batch": batch}


def _run(cfg, shape, mesh, rules) -> dict:
    """One step of ``cfg`` at ``shape`` on rank 0 of ``mesh``, measured."""
    model = get_model(cfg)
    if shape.kind == "train":
        step, args = _train_args(cfg, shape, mesh, rules)

        def call():
            return step(args["params"], AdamWState(0, *args["optimizer"]),
                        args["batch"])
    else:
        params = params_abstract(cfg, mesh, rules)
        cache = cache_abstract(cfg, shape, mesh)
        if shape.kind == "prefill":
            batch = batch_specs(cfg, shape, mesh)
            batch.pop("targets")
            args = {"params": params, "batch": batch, "cache": cache}

            def call():
                return model.prefill(params, cfg, batch, cache)
        else:
            tokens = decode_tokens_abstract(cfg, shape, mesh)
            args = {"params": params, "batch": tokens, "cache": cache}

            def call():
                return model.decode_step(params, cfg, cache, tokens)
    arg_bytes = {k: tree_bytes(v) for k, v in args.items()}
    collectives.STATS.reset()
    cost.LEDGER.reset()
    live = LiveBytes()
    for t in tree_flatten(args)[0]:
        live.track(t)
    flops = FlopCounterMode(display=False)
    with mesh_utils.use_mesh(mesh), flops, live:
        call()
        top = live.top()
    ledger = cost.LEDGER.snapshot()
    coll = {op: v["bytes"] for op, v in collectives.STATS.ops.items()}
    coll["count"] = sum(v["calls"] for v in collectives.STATS.ops.values())
    return {"argument_bytes": arg_bytes,
            "arguments": sum(arg_bytes.values()), "peak": live.peak,
            "matmul_flops": flops.get_total_flops(),
            "kernel_flops": sum(k["flops"] for k in ledger["kernels"].values()),
            "kernel_bytes": sum(k["bytes"] for k in ledger["kernels"].values()),
            "kernels": ledger["kernels"],
            "kernels_unbuilt": ledger["kernels_unbuilt"],
            "collectives": coll,
            "collectives_by_axis": {f"{op}:{ax}": n for (op, ax), n in
                                    sorted(collectives.STATS.by_axis.items())},
            "largest_live": top}


def _extrapolate(one, two, units: float):
    """f(1) + (units - 1)·(f(2) - f(1)), through dicts of numbers."""
    if isinstance(one, dict):
        return {k: _extrapolate(one[k], two.get(k, 0), units) for k in one}
    return one + (units - 1) * (two - one)


def _mesh_tag(mesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh=None, opt: bool = False, attention_override=None,
               config_override=None, layers=None, batch=None, seq=None,
               kind=None, smoke=False) -> dict:
    """The dry run of one cell. ``mesh`` (default: the production mesh,
    ``multi_pod`` picks which) may be any ``AbstractMesh``, e.g. one rank
    for a one-card run; ``layers`` / ``batch`` / ``seq`` cut depth /
    global batch / length; ``kind`` runs another step at the cell's shape
    (``"prefill"`` fills a decode cell's cache); ``smoke`` takes the arch's
    smoke config; the overrides are the reference's (``opt``: its
    optimized variant)."""
    shape = SHAPES[shape_name]
    for field, value in (("global_batch", batch), ("seq_len", seq),
                         ("kind", kind)):
        if value is not None:
            shape = dataclasses.replace(shape, **{field: value})
    cfg, rules = _config(arch, shape, opt, attention_override,
                         config_override, layers, smoke)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    chips = math.prod(mesh.shape.values())
    run_mesh = None if chips == 1 else mesh
    result = {"arch": arch, "shape": shape_name, "mesh": _mesh_tag(mesh),
              "chips": chips, "kind": shape.kind,
              "attention": cfg.attention.kind, "layers": cfg.num_layers,
              "global_batch": shape.global_batch, "seq_len": shape.seq_len,
              "param_dtype": cfg.param_dtype,
              "kv_quant": cfg.attention.kv_quant}
    t0 = time.time()
    if shape.kind == "train":
        period = max(len(cfg.block_pattern), 1)
        sub = {m: _run(cfg.replace(num_layers=period * m), shape, run_mesh,
                       rules) for m in (1, 2)}
        units = cfg.num_layers / period
        full_args = _train_args(cfg, shape, run_mesh, rules)[1]
        arg_bytes = {k: tree_bytes(v) for k, v in full_args.items()}
        del full_args
        def ext(one, two):
            return _extrapolate(one, two, units)

        measured = dict(sub[2], **{k: ext(sub[1][k], sub[2][k]) for k in (
            "matmul_flops", "kernel_flops", "kernel_bytes", "collectives",
            "collectives_by_axis")})
        measured["kernels"] = {
            k: dict(v, **{f: ext(sub[1]["kernels"].get(k, v)[f], v[f])
                          for f in ("calls", "flops", "bytes")})
            for k, v in sub[2]["kernels"].items()}
        measured["argument_bytes"] = arg_bytes
        measured["arguments"] = sum(arg_bytes.values())
        # the transients above the arguments grow linearly in depth too
        measured["peak"] = measured["arguments"] + ext(
            sub[1]["peak"] - sub[1]["arguments"],
            sub[2]["peak"] - sub[2]["arguments"])
        result["method"] = (f"unrolled depth {period}/{2 * period} linear "
                            "extrapolation")
    else:
        measured = _run(cfg, shape, run_mesh, rules)
    result["lower_s"] = round(time.time() - t0, 2)
    result["memory"] = {"argument_bytes": measured["argument_bytes"],
                        "arguments": measured["arguments"],
                        "peak_bytes": measured["peak"],
                        "largest_live": measured["largest_live"]}
    result["cost"] = {
        "matmul_flops_per_device": measured["matmul_flops"],
        "kernel_flops_per_device": measured["kernel_flops"],
        "kernel_bytes_per_device": measured["kernel_bytes"],
        "flops_per_device": measured["matmul_flops"] + measured["kernel_flops"]}
    result["kernels"] = measured["kernels"]
    result["kernels_unbuilt"] = measured["kernels_unbuilt"]
    result["collectives"] = measured["collectives"]
    result["collectives_by_axis"] = measured["collectives_by_axis"]
    result["mesh_axes"] = dict(mesh.shape)
    result["model_flops_total"] = model_flops(cfg, shape)
    return result


def run_cell(arch, shape_name, multi_pod, *, force=False,
             results_dir=RESULTS_DIR):
    os.makedirs(results_dir, exist_ok=True)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    fname = Path(results_dir) / f"{arch}__{shape_name}__{mesh_tag}.json"
    if fname.exists() and not force:
        cached = json.loads(fname.read_text())
        if cached.get("status") in ("ok", "skipped"):
            print(f"[cached] {arch} x {shape_name} x {mesh_tag}")
            return cached
    skip = shape_skips(arch, shape_name)
    if skip:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "skipped", "reason": skip}
    else:
        try:
            res = lower_cell(arch, shape_name, multi_pod=multi_pod)
            res["status"] = "ok"
            print(f"[ok] {arch} x {shape_name} x {mesh_tag}: "
                  f"{res['lower_s']}s peak "
                  f"{res['memory']['peak_bytes'] / 2**30:.2f} GiB/rank"
                  + (f" unbuilt {res['kernels_unbuilt']}"
                     if res["kernels_unbuilt"] else ""), flush=True)
        except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
            res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-3000:]}
            print(f"[FAIL] {arch} x {shape_name} x {mesh_tag}: "
                  f"{type(e).__name__}: {e}", flush=True)
    fname.write_text(json.dumps(res, indent=1))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or --all")
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only or args.multi_pod:
        meshes = [True]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                res = run_cell(arch, shape, mp, force=args.force,
                               results_dir=args.results_dir)
                n_fail += res.get("status") == "error"
    print(f"done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

