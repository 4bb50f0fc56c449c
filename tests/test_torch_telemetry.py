"""Port parity: serving telemetry (repro_torch.serve.telemetry).

The reference's telemetry suite (``tests/test_telemetry.py``) run against
the port: the declared-at-init registry (undeclared names raise), bounded
histograms, gauge peaks and the ``StatsView`` facade; token streams
bitwise equal with telemetry on and off, plain and speculative; monotonic
lifecycle stamps with TTFT decomposing exactly; a well-formed Chrome trace
that survives a JSONL round trip; per-slot acceptance series; occupancy
gauges for the port's cache layouts (ring-paged at H = 2 and H = 3, dense)
and for the state-cache families (rwkv6's state, recurrentgemma's window).
Beyond it: after the same greedy run the port's snapshot declares the
reference engine's counter, gauge, histogram and series names with equal
counter values, dispatch spans reach ``torch.profiler``, and the module's
self-test runs.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model, init_params as jax_init
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import Request as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.serve import (
    Engine,
    EngineConfig,
    Request,
    SamplingParams,
    UndeclaredMetric,
)
from repro_torch.serve.telemetry import (
    MetricsRegistry,
    StatsView,
    _selftest,
    load_trace_jsonl,
    validate_chrome_events,
)
from test_torch_engine import _greedy_mix, _run

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config("qwen3-1.7b", activ_dtype="float32")


@pytest.fixture(scope="module")
def params(cfg):
    return init_params(cfg, seed=0, device="cpu")


def _requests():
    """Ragged mix with readmission pressure (4 requests, 2 slots below)."""
    return [
        Request(prompt=np.arange(1, 20), max_new_tokens=6,
                sampling=SamplingParams(temperature=0.9, seed=7)),
        Request(prompt=np.array([5, 11, 2]), max_new_tokens=4),
        Request(prompt=np.arange(2, 12), max_new_tokens=5,
                sampling=SamplingParams(temperature=1.0, top_k=5, seed=3)),
        Request(prompt=np.array([9]), max_new_tokens=3),
    ]


def _engine(cfg, params, **kw):
    base = dict(slots=2, max_len=64, chunk=8)
    base.update(kw)
    return Engine(cfg, params, EngineConfig(**base), device="cpu")


# --------------------------------------------------------------------------- #
# typed metrics registry
# --------------------------------------------------------------------------- #
def test_undeclared_metric_raises(cfg, params):
    eng = _engine(cfg, params)
    with pytest.raises(UndeclaredMetric):
        eng.stats["invented_key"]
    with pytest.raises(UndeclaredMetric):
        eng.stats["invented_key"] = 1
    with pytest.raises(UndeclaredMetric):
        eng.telemetry.metrics.inc("invented_key")
    with pytest.raises(UndeclaredMetric):
        eng.telemetry.metrics.observe("invented_seconds", 0.1)
    assert issubclass(UndeclaredMetric, KeyError)
    assert "invented_key" not in eng.stats


def test_reset_stats_declares_every_writer_key(cfg, params):
    eng = _engine(cfg, params, spec_k=2)
    eng.run(_requests())
    assert eng.stats["spec_rounds"] > 0
    eng.reset_stats()
    for key in ("prefill_dispatches", "decode_dispatches", "prefill_tokens",
                "generated_tokens", "requests_completed", "spec_rounds",
                "draft_dispatches", "verify_dispatches", "spec_drafted_tokens",
                "spec_accepted_tokens", "spec_emitted_tokens"):
        assert eng.stats[key] == 0, key
    assert eng.stats["decode_step_seconds"] == []
    done = eng.run(_requests()[:1])
    assert len(done) == 1 and eng.stats["spec_rounds"] >= 0


def test_registry_types_and_bounds():
    m = MetricsRegistry()
    m.declare_counter("n")
    m.declare_histogram("lat", maxlen=4)
    m.declare_gauge("occ")
    with pytest.raises(ValueError, match="declared twice"):
        m.declare_counter("n")
    for i in range(10):  # reservoir stays bounded; count/sum stay exact
        m.observe("lat", float(i))
    h = m.get("lat")
    assert len(h.reservoir) == 4 and h.count == 10 and h.total == 45.0
    m.set_gauge("occ", 3.0)
    m.set_gauge("occ", 1.0)
    assert m.get("occ").value == 1.0 and m.get("occ").peak == 3.0
    with pytest.raises(TypeError, match="histogram"):
        m.inc("lat")
    view = StatsView(m)
    view["n"] += 2  # the read-modify-write idiom
    assert view["n"] == 2
    with pytest.raises(TypeError, match="observe-only"):
        view["lat"] = [1.0]


def test_snapshot_json_roundtrip_and_prometheus(cfg, params):
    eng = _engine(cfg, params)
    eng.run(_requests())
    snap = eng.telemetry.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert snap["tags"]["family"] == cfg.family
    assert snap["counters"]["requests_completed"] == 4
    for name in ("ttft_seconds", "inter_token_seconds", "queue_wait_seconds",
                 "prefill_seconds", "decode_step_seconds",
                 "prefill_chunk_seconds"):
        h = snap["histograms"][name]
        assert set(h) == {"count", "sum", "mean", "p50", "p90", "p99", "max"}
    assert snap["histograms"]["ttft_seconds"]["count"] == 4
    assert snap["histograms"]["ttft_seconds"]["p99"] > 0
    text = eng.telemetry.prometheus_text()
    assert "mra_serve_requests_completed 4" in text
    assert 'mra_serve_ttft_seconds{quantile="0.99"}' in text
    assert "mra_serve_cache_pages_live" in text


def test_prefill_dispatches_are_timed(cfg, params):
    eng = _engine(cfg, params)
    eng.run(_requests())
    h = eng.telemetry.snapshot()["histograms"]["prefill_chunk_seconds"]
    assert h["count"] == eng.stats["prefill_dispatches"] > 0
    assert h["sum"] > 0


# --------------------------------------------------------------------------- #
# observer effect: telemetry never changes tokens
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("spec_k", [0, 2])
def test_tokens_bit_identical_with_telemetry_on_vs_off(cfg, params, spec_k):
    on = _engine(cfg, params, spec_k=spec_k, telemetry=True).run(_requests())
    off = _engine(cfg, params, spec_k=spec_k, telemetry=False).run(_requests())
    by = {len(r.prompt): r.out for r in off}
    for r in on:
        np.testing.assert_array_equal(r.out, by[len(r.prompt)])


def test_h3_spec_tokens_bit_identical_with_telemetry_on_vs_off(cfg, params):
    """The same at levels=3, speculative, with a prompt past the window."""
    h3 = cfg.replace(attention=cfg.attention.replace(levels=3))

    def reqs():
        return [Request(prompt=np.arange(1, 120) % 512, max_new_tokens=20),
                Request(prompt=np.arange(3, 30), max_new_tokens=12)]

    on = _engine(h3, params, chunk=32, spec_k=3, telemetry=True)
    off = _engine(h3, params, chunk=32, spec_k=3, telemetry=False)
    by = {len(r.prompt): r.out for r in off.run(reqs())}
    for r in on.run(reqs()):
        np.testing.assert_array_equal(r.out, by[len(r.prompt)])
    assert on.stats["spec_rounds"] == off.stats["spec_rounds"] > 0


def test_batched_equals_solo_under_telemetry(cfg, params):
    batched = _engine(cfg, params, telemetry=True).run(_requests())
    by = {len(r.prompt): r.out for r in batched}
    for req in _requests():
        solo = _engine(cfg, params, telemetry=False).run([req])[0]
        np.testing.assert_array_equal(solo.out, by[len(solo.prompt)])


def test_disabled_path_is_noop(cfg, params):
    eng = _engine(cfg, params, telemetry=False)
    done = eng.run(_requests())
    assert eng.stats["requests_completed"] == 4
    assert eng.stats["generated_tokens"] > 0
    assert eng.stats["decode_step_seconds"] == []
    snap = eng.telemetry.snapshot()
    assert snap["histograms"]["ttft_seconds"]["count"] == 0
    assert snap["gauges"]["cache_pages_live"]["peak"] == 0.0
    assert len(eng.telemetry.trace.events) == 0
    assert all(r.trace is None for r in done)


# --------------------------------------------------------------------------- #
# request-lifecycle tracing
# --------------------------------------------------------------------------- #
def test_lifecycle_stamps_and_ttft_decomposition(cfg, params):
    eng = _engine(cfg, params)
    done = eng.run(_requests())
    for r in done:
        tr = r.trace
        assert tr is not None
        assert (tr.submit <= tr.admit <= tr.prefill_done
                <= tr.first_token <= tr.complete)
        assert len(tr.token_times) == r.max_new_tokens
        assert tr.token_times == sorted(tr.token_times)
        assert len(tr.inter_token) == r.max_new_tokens - 1
        parts = (tr.queue_wait + (tr.prefill_done - tr.admit)
                 + (tr.first_token - tr.prefill_done))
        assert abs(tr.ttft - parts) < 1e-9
        assert tr.ttft > 0


def test_trace_events_well_formed_and_jsonl_roundtrip(cfg, params, tmp_path):
    eng = _engine(cfg, params, spec_k=2)
    eng.run(_requests()
            + [Request(prompt=np.array([], np.int32), max_new_tokens=2)])
    events = eng.telemetry.trace.chrome_events()
    validate_chrome_events(events)
    names = {e["name"] for e in events}
    assert {"request", "queued", "prefill", "decode",
            "prefill_chunk", "draft", "verify"} <= names
    assert {e["tid"] for e in events if e["name"] == "request"} \
        <= set(range(eng.slots))
    assert all(e["tid"] == eng.telemetry.ENGINE_TID
               for e in events if e["name"] == "prefill_chunk")
    path = tmp_path / "trace.jsonl"
    n = eng.telemetry.trace.export_jsonl(str(path))
    loaded = load_trace_jsonl(str(path))
    assert len(loaded) == n
    validate_chrome_events(loaded)


def test_spec_acceptance_series_per_slot(cfg, params):
    eng = _engine(cfg, params, spec_k=2)
    done = eng.run(_requests())
    series = eng.telemetry.snapshot()["series"]["spec_accept_by_slot"]
    assert series, "speculative engine recorded no per-slot acceptance"
    assert set(series) <= {str(s) for s in range(eng.slots)}
    total = sum(v for vs in series.values() for v in vs)
    assert total == eng.stats["spec_accepted_tokens"]
    assert sum(a for r in done for a in r.trace.spec_accepts) == total


# --------------------------------------------------------------------------- #
# occupancy across the port's cache layouts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout,evicting", [
    ("ring", True),    # ring-paged MRA cache: ring eviction
    ("h3", True),      # collapse-up hierarchy: evicted pages live on
    ("dense", False),  # exact attention: hard capacity, never evicts
])
def test_cache_occupancy_gauges_all_layouts(cfg, params, layout, evicting):
    attn = {"ring": cfg.attention, "h3": cfg.attention.replace(levels=3),
            "dense": cfg.attention.replace(kind="full")}[layout]
    max_len = 64 if layout == "dense" else 32
    eng = Engine(cfg.replace(attention=attn), params,
                 EngineConfig(slots=2, max_len=max_len, chunk=8), device="cpu")
    eng.run([Request(prompt=np.arange(1, 9), max_new_tokens=30),
             Request(prompt=np.array([3, 4, 5]), max_new_tokens=4)])
    g = eng.telemetry.snapshot()["gauges"]
    for key in ("cache_slots_active", "cache_tokens_live", "cache_pages_live",
                "cache_tokens_evicted", "slots_free", "slots_decode",
                "queue_depth"):
        assert key in g, key
    assert g["cache_slots_active"]["peak"] == 2
    assert g["cache_tokens_live"]["peak"] > 0
    assert g["slots_free"]["value"] == 2
    if evicting:
        assert g["cache_pages_live"]["peak"] > 0
        assert g["cache_tokens_evicted"]["peak"] > 0
    else:
        assert g["cache_pages_live"]["peak"] == 0.0
        assert g["cache_tokens_evicted"]["peak"] == 0.0
    if layout == "h3":
        assert g["cache_level2_tokens"]["peak"] > 0


@pytest.mark.parametrize("arch,evicting", [
    ("rwkv6-7b", False),          # RecurrentStateCache: state absorbs history
    ("recurrentgemma-9b", True),  # HybridWindowCache: the window slides
])
def test_cache_occupancy_gauges_state_families(arch, evicting):
    """The reference's occupancy case for the state-cache families: a
    generation past the window evicts from recurrentgemma's ring (ring
    entries count as pages) and nothing from rwkv6's state."""
    scfg = get_smoke_config(arch)
    eng = Engine(scfg, init_params(scfg, seed=0, device="cpu"),
                 EngineConfig(slots=2, max_len=32, chunk=8), device="cpu")
    eng.run([Request(prompt=np.arange(1, 9), max_new_tokens=30),
             Request(prompt=np.array([3, 4, 5]), max_new_tokens=4)])
    g = eng.telemetry.snapshot()["gauges"]
    assert g["cache_slots_active"]["peak"] == 2
    assert g["cache_tokens_live"]["peak"] > 0
    assert g["slots_free"]["value"] == 2
    if evicting:
        assert g["cache_pages_live"]["peak"] > 0
        assert g["cache_tokens_evicted"]["peak"] > 0
        assert g["cache_tokens_live"]["peak"] <= 2 * 32  # min(L, W) a slot
    else:
        assert g["cache_pages_live"]["peak"] == 0.0
        assert g["cache_tokens_evicted"]["peak"] == 0.0


# --------------------------------------------------------------------------- #
# beyond the reference suite
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("spec_k", [0, 3])
def test_snapshot_declares_the_jax_engine_metrics(spec_k):
    """After the same greedy run the port declares the reference engine's
    metric names of every kind, with equal counter values."""
    jcfg = jax_smoke("qwen3-1.7b", activ_dtype="float32")
    tcfg = get_smoke_config("qwen3-1.7b", activ_dtype="float32")
    jp = jax_init(get_model(jcfg).param_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.device_get(jp), tcfg, device="cpu")
    ecfg = dict(slots=3, max_len=64, chunk=8, spec_k=spec_k)
    jeng = JEngine(jcfg, jp, JEngineConfig(**ecfg))
    ref = _run(JEngine, JRequest, jeng, _greedy_mix())
    eng = Engine(tcfg, tp, EngineConfig(**ecfg), device="cpu")
    got = _run(Engine, Request, eng, _greedy_mix())
    for plen in ref:
        np.testing.assert_array_equal(got[plen], ref[plen])
    want, have = jeng.telemetry.snapshot(), eng.telemetry.snapshot()
    for kind in ("counters", "gauges", "histograms", "series"):
        assert set(have[kind]) == set(want[kind]), kind
    assert have["counters"] == want["counters"]
    for name, h in want["histograms"].items():  # same observation counts
        assert have["histograms"][name]["count"] == h["count"], name


def test_dispatch_spans_reach_the_torch_profiler(cfg, params):
    from torch.profiler import ProfilerActivity, profile

    eng = _engine(cfg, params, spec_k=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(_requests()[1:2])
    keys = {e.key for e in prof.key_averages()}
    assert {"serve.prefill_chunk", "serve.draft", "serve.verify"} <= keys


def test_selftest_in_process_and_as_a_module(capsys):
    _selftest()
    assert "selftest OK" in capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.serve.telemetry"],
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "selftest OK" in res.stdout
