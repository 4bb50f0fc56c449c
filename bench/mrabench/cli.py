"""``bench/run.py``: one run of one cell, driven by ``BENCHMARK.json``.

The cell names a configuration (its file, under ``configs``) and a traffic
mix (``bench/traffic/<traffic>.json``, whose ``kind`` picks the runner:
``serve`` or ``train``). A per-layer metric is read by
``bench/metrics/<name>.py`` (its ``read(run)`` returns a number, or None
where it finds nothing to read). The last line on standard output is the
result; the numbers compared for ``correct`` end standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import sys
import traceback
from pathlib import Path

from .clock import since_start

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Modules (default: those loaded) whose top-level name is JAX's or
    the JAX package's, compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell's entries: workload, configuration (with its file's
    contents), traffic mix, and the metrics it reports."""
    spec = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    # every metric but setup_s lists its cells
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in spec["per_layer"] if name in m["workloads"]]
    return dict(cell=cell, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=layer)


def model_config(model: dict):
    """The program's ``ModelConfig`` of the configuration file's model."""
    from repro_torch.configs.base import ModelConfig, MoESpec
    from repro_torch.core.attention import AttentionSpec

    fields = dict(model)
    fields["attention"] = AttentionSpec(**fields["attention"])
    if fields.get("moe"):
        fields["moe"] = MoESpec(**fields["moe"])
    return ModelConfig(**fields)


class Run:
    """What one run measures and compares; the runners fill it."""

    def __init__(self, spec: dict, *, seed: int, seconds: float,
                 trace: bool, device, control: bool = False):
        import torch

        self.torch = torch
        self.spec = spec
        self.model = spec["config"]["model"]
        self.limits = spec["config"]["limits"]
        self.traffic = spec["traffic"]
        self.cfg = model_config(self.model)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.control = control
        self.e2e, self.layer_inputs, self.notes = {}, {}, {}
        self.checks, self.control_readings = {}, {}
        self.attempted = self.failed = 0
        self.window_s = self.setup_s = None
        self.memory_peak = 0
        self.summary = self.recorder = self._trace = None

    # ---- the device ------------------------------------------------------ #
    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = self.torch.cuda.max_memory_allocated(
                self.device)

    # ---- the window ------------------------------------------------------ #
    def window_start(self) -> None:
        self.setup_s = since_start()

    @contextlib.contextmanager
    def traced(self):
        if not self.trace:
            yield
            return
        from .trace import Recorder, Trace

        self.recorder, self._trace = Recorder(), Trace()
        with self.recorder.installed(), self._trace.window():
            yield

    def window_end(self) -> None:
        if self._trace is not None:
            self.summary = self._trace.summary()
            self._trace = None

    # ---- correctness ------------------------------------------------------ #
    def compare(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and self.attempted > 0 and bool(self.checks)
                and all(c["value"] <= c["limit"]
                        for c in self.checks.values()))


def runner(kind: str):
    from . import serve, train

    return {"serve": serve.run, "train": train.run}[kind]


def read_metric(name: str, run: Run):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "mrabench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(run)


def result(run: Run) -> dict:
    spec = run.spec
    metrics = {}
    if run.trace:
        for m in spec["per_layer"]:
            v = read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in spec["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    torch = run.torch
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": int(spec["cell"]["chips"]),
           "memory_peak_bytes": int(run.memory_peak)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.summary is not None:
        dev["busy_s"] = run.summary["busy_s"]
        dev["window_s"] = run.summary["window_s"]
        out["breakdown"] = {"device_ops": run.summary["device_ops"],
                            "idle_gaps": run.summary["idle_gaps"]}
    out["notes"] = dict(run.notes, window_s=run.window_s)
    if run.control:
        out["control"] = run.control_readings
    out["checks"] = run.checks
    return out


def execute(spec: dict, *, seed: int, seconds: float, trace: bool,
            device, control: bool = False) -> dict:
    """Set up, measure and check one run of a cell; returns the result."""
    run = Run(spec, seed=seed, seconds=seconds, trace=trace, device=device,
              control=control)
    runner(spec["traffic"]["kind"])(run)
    return result(run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also run the float8 control of the reference and "
                         "report its readings (for setting limits)")
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    try:
        out = execute(spec, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda:0",
                      control=args.control)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    for name, v in out.get("control", {}).items():
        print(f"control {name} {v!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
