"""BENCHMARK.json against the contract's form, and every cell's files found
by name."""
import importlib.util
import json
import re

from benchutil import BENCH

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert all("workloads" in m for m in SPEC["per_layer"])
    assert all("workloads" in m for m in SPEC["end_to_end"]
               if m["name"] != "setup_s")
    assert all(0 < m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    assert 1 <= SPEC["run_seconds"] <= 51
    texts = [e.get(k) for group in ("configs", "workloads", "per_layer")
             for e in SPEC[group] for k in ("why", "layer", "source")]
    for text in [x for x in texts if x is not None] + SPEC["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_cell_finds_its_files():
    from mrabench import cli

    for w in SPEC["workloads"]:
        spec = cli.load_cell(w["name"])
        model = spec["config"]["model"]
        cli.model_config(model)  # the program takes the file's model
        assert spec["traffic"]["kind"] in ("serve", "train")
        assert spec["per_layer"] and len(spec["end_to_end"]) >= 2
        for m in spec["per_layer"]:
            path = BENCH / "metrics" / f"{m['name']}.py"
            mod_spec = importlib.util.spec_from_file_location("m", path)
            mod = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(mod)
            assert callable(mod.read)
            assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_config_files_state_their_source():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert set(conf["reduced"]) <= set(conf["published"])


def test_weights_match_the_program_layout():
    """The benchmark's weight tree has the program's leaves, shapes and
    dtypes (repro_torch.models.params.param_specs)."""
    import torch

    from benchutil import small_spec
    from mrabench import cli, weights
    from repro_torch.models.params import param_specs, spec_paths

    for cell in ("qwen3-1.7b.serve-longdoc", "granite-moe-3b-a800m.train-4k"):
        model = small_spec(cell)["config"]["model"]
        cfg = cli.model_config(model)
        params, _ = weights.make(model, 3, "cpu")
        ours = {n: (tuple(t.shape), t.dtype)
                for n, t in weights.leaf_paths(params)}
        theirs = {".".join(p): (s.shape, s.dtype)
                  for p, s in spec_paths(param_specs(cfg))}
        assert ours == theirs
        again, stacks = weights.make(model, 3, "cpu")
        for (_, a), (_, b) in zip(weights.leaf_paths(params),
                                  weights.leaf_paths(again)):
            assert torch.equal(a, b)
        for t in stacks:  # drawn again in place: the same bits
            t.add_(1.0)
        weights.redraw(model, 3, stacks)
        for (_, a), (_, b) in zip(weights.leaf_paths(params),
                                  weights.leaf_paths(again)):
            assert torch.equal(a, b)
