"""Serving telemetry: typed metrics, request-lifecycle tracing, profiling hooks.

Port of ``repro/serve/telemetry.py`` (DESIGN.md §13); pure Python apart
from the profiler annotation. Three surfaces, one owner object
(``Telemetry``, one per Engine):

  * **Typed metrics registry** — ``Counter`` / ``Gauge`` / ``Histogram`` /
    ``Series`` instances declared *at init* (``Engine.reset_stats``).
    Writing a name that was never declared raises ``UndeclaredMetric``, so
    the scheduler / SpecDecoder can no longer invent keys by dict mutation
    (the old ``Engine.stats`` ad-hoc dict). Histograms keep a *bounded*
    reservoir (a long-lived engine must not grow host memory per step) plus
    exact count/sum; gauges track their peak. ``Engine.stats`` survives as
    a compatibility ``StatsView`` over the registry.

  * **Request-lifecycle tracing** — every request carries a
    ``RequestTrace`` stamped at submit → admit → prefill-done →
    first-token → per-token → complete. The stamps feed the ttft /
    queue-wait / prefill / inter-token histograms live, and at completion
    the lifecycle is emitted as Chrome-trace begin/end span pairs
    (exportable as JSONL for chrome://tracing / Perfetto; one event object
    per line).

  * **Per-dispatch profiling hooks** — ``Telemetry.dispatch`` wraps every
    engine dispatch (prefill_chunk, decode_step, draft, verify) in a
    wall-clock span + ``torch.profiler.record_function`` (the counterpart
    of ``jax.profiler.TraceAnnotation``) tagged with kernel mode and cache
    family, so a torch.profiler trace and the host trace line up.

Everything is gated on ``Telemetry.enabled``: disabled, the span/stamp/
gauge paths are no-ops (``EngineConfig(telemetry=False)``) — only the
plain integer counters the engine's own bookkeeping needs keep counting.
Token streams are bit-identical either way: the clock never touches
numerics.

``python -m repro_torch.serve.telemetry`` runs the self-test: a snapshot
must round-trip through JSON and a recorded trace must be well-formed.
"""
from __future__ import annotations

import collections
import collections.abc
import contextlib
import dataclasses
import json
import time
from typing import Dict, Iterator, List, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RequestTrace",
    "Series",
    "StatsView",
    "Telemetry",
    "Tracer",
    "UndeclaredMetric",
    "load_trace_jsonl",
    "validate_chrome_events",
]


class UndeclaredMetric(KeyError):
    """Raised when reading/writing a metric name nobody declared at init."""


# --------------------------------------------------------------------------- #
# typed metrics
# --------------------------------------------------------------------------- #
class Counter:
    """Monotonic int counter (resettable only by re-declaring the registry)."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += int(n)


class Gauge:
    """Last-write-wins float with a high-water mark (``peak``)."""

    kind = "gauge"
    __slots__ = ("value", "peak")

    def __init__(self):
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.peak:
            self.peak = self.value


class Histogram:
    """Bounded-reservoir distribution: exact count/sum, windowed quantiles.

    The reservoir is a ``deque(maxlen=...)`` — quantiles describe the most
    recent observations (what a serving dashboard wants), while ``count`` /
    ``total`` stay exact for the whole lifetime. This is the fix for the
    unbounded ``stats["decode_step_seconds"]`` list the old engine grew
    per decode step.
    """

    kind = "histogram"
    __slots__ = ("reservoir", "count", "total")

    def __init__(self, maxlen: int = 4096):
        self.reservoir: collections.deque = collections.deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def observe(self, x: float) -> None:
        x = float(x)
        self.reservoir.append(x)
        self.count += 1
        self.total += x

    def percentile(self, q: float) -> float:
        """Reservoir quantile, ``q`` in [0, 1]; 0.0 when empty."""
        if not self.reservoir:
            return 0.0
        xs = sorted(self.reservoir)
        return xs[min(len(xs) - 1, int(len(xs) * q))]

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.total / self.count if self.count else 0.0,
            "p50": self.percentile(0.5),
            "p90": self.percentile(0.9),
            "p99": self.percentile(0.99),
            "max": max(self.reservoir) if self.reservoir else 0.0,
        }


class Series:
    """Bounded per-key value series (e.g. per-slot spec acceptance)."""

    kind = "series"
    __slots__ = ("maxlen", "data")

    def __init__(self, maxlen: int = 1024):
        self.maxlen = maxlen
        self.data: Dict[str, collections.deque] = {}

    def append(self, key, v: float) -> None:
        key = str(key)
        if key not in self.data:
            self.data[key] = collections.deque(maxlen=self.maxlen)
        self.data[key].append(float(v))


class MetricsRegistry:
    """Declared-at-init metric set; undeclared names raise.

    One flat namespace (metric names are the contract, DESIGN.md §13); the
    declaring site (``Engine.reset_stats``) is the single source of truth
    for which names exist, so a typo'd or invented key fails loudly at the
    write site instead of silently forking the schema.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    # ---- declaration (init time only) -------------------------------------- #
    def _declare(self, name: str, metric):
        if name in self._metrics:
            raise ValueError(f"metric {name!r} declared twice")
        self._metrics[name] = metric
        return metric

    def declare_counter(self, *names: str) -> None:
        for n in names:
            self._declare(n, Counter())

    def declare_gauge(self, *names: str) -> None:
        for n in names:
            self._declare(n, Gauge())

    def declare_histogram(self, *names: str, maxlen: int = 4096) -> None:
        for n in names:
            self._declare(n, Histogram(maxlen=maxlen))

    def declare_series(self, *names: str, maxlen: int = 1024) -> None:
        for n in names:
            self._declare(n, Series(maxlen=maxlen))

    # ---- access ------------------------------------------------------------ #
    def get(self, name: str):
        try:
            return self._metrics[name]
        except KeyError:
            raise UndeclaredMetric(
                f"metric {name!r} was never declared; telemetry metric sets "
                "are fixed at init (Engine.reset_stats) — declare it there "
                "instead of inventing keys at the write site") from None

    def _typed(self, name: str, cls):
        m = self.get(name)
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {m.kind}, not a {cls.kind}")
        return m

    def inc(self, name: str, n: int = 1) -> None:
        self._typed(name, Counter).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self._typed(name, Gauge).set(v)

    def observe(self, name: str, x: float) -> None:
        self._typed(name, Histogram).observe(x)

    def append(self, name: str, key, v: float) -> None:
        self._typed(name, Series).append(key, v)

    def names(self) -> List[str]:
        return list(self._metrics)

    def items(self):
        return self._metrics.items()

    # ---- export ------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, dict]:
        """JSON-able nested dict of every declared metric's current value."""
        out = {"counters": {}, "gauges": {}, "histograms": {}, "series": {}}
        for name, m in self._metrics.items():
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = {"value": m.value, "peak": m.peak}
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.summary()
            elif isinstance(m, Series):
                out["series"][name] = {k: list(v) for k, v in m.data.items()}
        return out

    def prometheus_text(self, prefix: str = "mra_serve_") -> str:
        """Prometheus exposition-format snapshot (counters/gauges/summaries)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            full = prefix + name
            if isinstance(m, Counter):
                lines += [f"# TYPE {full} counter", f"{full} {m.value}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {full} gauge", f"{full} {m.value:.9g}",
                          f"# TYPE {full}_peak gauge",
                          f"{full}_peak {m.peak:.9g}"]
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {full} summary")
                for q in (0.5, 0.9, 0.99):
                    lines.append(f'{full}{{quantile="{q}"}} '
                                 f"{m.percentile(q):.9g}")
                lines += [f"{full}_sum {m.total:.9g}",
                          f"{full}_count {m.count}"]
            # series are a trace-shaped surface; they export via snapshot()
        return "\n".join(lines) + "\n"


class StatsView(collections.abc.Mapping):
    """``Engine.stats`` compatibility facade over the typed registry.

    Reads return plain values (counter/gauge -> number, histogram -> the
    reservoir as a list — ``sorted(stats["decode_step_seconds"])`` keeps
    working). Writes are allowed for *declared* counters only, so the
    pre-telemetry ``stats["draft_dispatches"] += 1`` idiom still works but
    an undeclared key raises ``UndeclaredMetric`` instead of minting one.
    """

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def __getitem__(self, name: str):
        m = self._registry.get(name)
        if isinstance(m, Counter):
            return m.value
        if isinstance(m, Gauge):
            return m.value
        if isinstance(m, Histogram):
            return list(m.reservoir)
        return {k: list(v) for k, v in m.data.items()}

    def __setitem__(self, name: str, value) -> None:
        m = self._registry.get(name)
        if isinstance(m, Counter):
            m.value = int(value)
        elif isinstance(m, Gauge):
            m.set(value)
        else:
            raise TypeError(
                f"{m.kind} {name!r} is observe-only; use the Telemetry API")

    def __iter__(self) -> Iterator[str]:
        return iter(self._registry.names())

    def __len__(self) -> int:
        return len(self._registry.names())


# --------------------------------------------------------------------------- #
# request-lifecycle tracing
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RequestTrace:
    """Per-request lifecycle stamps (seconds on the tracer's clock).

    ``submit -> admit -> prefill_done -> first_token -> ... -> complete``;
    ``token_times`` holds every sampled-token stamp (first included) and
    ``spec_accepts`` the per-round accepted-draft counts for this request.
    """

    submit: Optional[float] = None
    admit: Optional[float] = None
    prefill_done: Optional[float] = None
    first_token: Optional[float] = None
    complete: Optional[float] = None
    slot: Optional[int] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    spec_accepts: List[int] = dataclasses.field(default_factory=list)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None or self.submit is None:
            return None
        return self.first_token - self.submit

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admit is None or self.submit is None:
            return None
        return self.admit - self.submit

    @property
    def inter_token(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]


class Tracer:
    """Bounded Chrome-trace event buffer on a monotonic clock started at
    construction."""

    def __init__(self, max_events: int = 65536):
        self._t0 = time.perf_counter()
        self.events: collections.deque = collections.deque(maxlen=max_events)

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def event(self, ph: str, name: str, ts: float, tid: int,
              args: Optional[dict] = None) -> None:
        ev = {"ph": ph, "name": name, "pid": 0, "tid": int(tid),
              "ts": round(ts * 1e6, 3)}  # Chrome trace wants microseconds
        if args:
            ev["args"] = args
        self.events.append(ev)

    def span(self, name: str, t_begin: float, t_end: float, tid: int,
             args: Optional[dict] = None) -> None:
        self.event("B", name, t_begin, tid, args)
        self.event("E", name, t_end, tid)

    def instant(self, name: str, ts: float, tid: int,
                args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "name": name, "pid": 0, "tid": int(tid),
              "ts": round(ts * 1e6, 3), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts: float, tid: int, value: float) -> None:
        self.event("C", name, ts, tid, {"value": value})

    def chrome_events(self) -> List[dict]:
        """Events sorted by timestamp + thread-name metadata (valid Chrome
        trace when wrapped in a JSON array; Perfetto loads it directly)."""
        evs = sorted(self.events, key=lambda e: (e["ts"], e["ph"] != "E"))
        names = {Telemetry.ENGINE_TID: "engine dispatches"}
        meta = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                 "args": {"name": names.get(tid, f"slot {tid}")}}
                for tid in sorted({e["tid"] for e in evs})]
        return meta + evs

    def export_jsonl(self, path: str) -> int:
        """Write one Chrome-trace event object per line; returns the count.

        ``load_trace_jsonl`` (or ``json.loads`` per line + wrapping in a
        JSON array) reconstructs a chrome://tracing-loadable document.
        """
        evs = self.chrome_events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return len(evs)


def load_trace_jsonl(path: str) -> List[dict]:
    """Parse a JSONL trace back into the Chrome-trace event list."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_chrome_events(events: List[dict]) -> None:
    """Assert trace well-formedness: schema, monotonic ts, matched B/E.

    Raises ``ValueError`` naming the first offending event otherwise.
    """
    stacks: Dict[int, List[str]] = {}
    last_ts = None
    for ev in events:
        missing = [k for k in ("ph", "name", "pid", "tid") if k not in ev]
        if missing:
            raise ValueError(f"trace event missing keys {missing}: {ev}")
        if ev["ph"] == "M":
            continue
        if "ts" not in ev:
            raise ValueError(f"non-metadata trace event without ts: {ev}")
        if last_ts is not None and ev["ts"] < last_ts:
            raise ValueError(
                f"trace timestamps not monotonic: {ev['ts']} after {last_ts}")
        last_ts = ev["ts"]
        if ev["ph"] == "B":
            stacks.setdefault(ev["tid"], []).append(ev["name"])
        elif ev["ph"] == "E":
            stack = stacks.setdefault(ev["tid"], [])
            if not stack:
                raise ValueError(f"unmatched end event: {ev}")
            stack.pop()
    open_spans = {tid: s for tid, s in stacks.items() if s}
    if open_spans:
        raise ValueError(f"unclosed begin events: {open_spans}")


# --------------------------------------------------------------------------- #
# the owner object
# --------------------------------------------------------------------------- #
class Telemetry:
    """One per Engine: registry + tracer + the lifecycle/dispatch helpers.

    ``enabled=False`` is the no-op fast path: lifecycle stamps, histogram
    observations, gauges, and trace events all short-circuit; counters
    (``metrics.inc``) stay live because they are the engine's own dispatch
    bookkeeping (and integer adds are far below the overhead budget).
    """

    ENGINE_TID = 1000  # trace lane for engine-level dispatch spans

    def __init__(self, enabled: bool = True, tags: Optional[dict] = None):
        self.enabled = enabled
        self.tags = dict(tags or {})
        self.metrics = MetricsRegistry()
        self.trace = Tracer()

    def now(self) -> float:
        return self.trace.now()

    # ---- per-dispatch profiling hooks -------------------------------------- #
    @contextlib.contextmanager
    def dispatch(self, name: str, hist: Optional[str] = None, **args):
        """Span one engine dispatch: wall clock + profiler annotation.

        ``hist`` names a declared histogram to observe the duration into;
        the trace span lands on the engine lane tagged with the telemetry's
        static tags (kernel mode, cache family) + ``args``.
        """
        if not self.enabled:
            yield
            return
        import torch  # deferred so metric-only users never pay the import

        t0 = self.now()
        with torch.profiler.record_function(f"serve.{name}"):
            yield
        t1 = self.now()
        if hist is not None:
            self.metrics.observe(hist, t1 - t0)
        self.trace.span(name, t0, t1, self.ENGINE_TID,
                        {**self.tags, **args} or None)

    # ---- request lifecycle -------------------------------------------------- #
    def on_submit(self, req) -> None:
        if self.enabled:
            req.trace = RequestTrace(submit=self.now())

    def on_admit(self, req, slot: int) -> None:
        if not (self.enabled and req.trace):
            return
        req.trace.admit = self.now()
        req.trace.slot = slot
        self.metrics.observe("queue_wait_seconds", req.trace.queue_wait)

    def on_prefill_done(self, req) -> None:
        if not (self.enabled and req.trace and req.trace.admit is not None):
            return
        req.trace.prefill_done = self.now()
        self.metrics.observe("prefill_seconds",
                             req.trace.prefill_done - req.trace.admit)

    def on_token(self, req) -> None:
        if not (self.enabled and req.trace):
            return
        t = self.now()
        tr = req.trace
        if tr.first_token is None:
            tr.first_token = t
            if tr.ttft is not None:
                self.metrics.observe("ttft_seconds", tr.ttft)
        elif tr.token_times:
            self.metrics.observe("inter_token_seconds",
                                 t - tr.token_times[-1])
        tr.token_times.append(t)

    def on_spec_accept(self, req, slot: int, n_accepted: int) -> None:
        if not self.enabled:
            return
        self.metrics.observe("spec_accepted_per_round", n_accepted)
        self.metrics.append("spec_accept_by_slot", slot, n_accepted)
        if req.trace:
            req.trace.spec_accepts.append(int(n_accepted))
        self.trace.counter("spec_accepted", self.now(), slot,
                           float(n_accepted))

    def on_complete(self, req) -> None:
        """Close the request's lifecycle and emit its trace spans."""
        if not (self.enabled and req.trace):
            return
        tr = req.trace
        tr.complete = self.now()
        if tr.slot is None:  # degenerate request: never held a slot
            return
        tid = tr.slot
        args = {"prompt_tokens": len(req.prompt),
                "new_tokens": len(tr.token_times)}
        if tr.ttft is not None:
            args["ttft_s"] = round(tr.ttft, 6)
        self.trace.span("request", tr.submit, tr.complete, tid, args)
        self.trace.span("queued", tr.submit, tr.admit, tid)
        if tr.prefill_done is not None:
            self.trace.span("prefill", tr.admit, tr.prefill_done, tid)
        if tr.first_token is not None:
            self.trace.span("decode", tr.first_token, tr.complete, tid)

    # ---- occupancy gauges --------------------------------------------------- #
    def set_occupancy(self, slot_counts: Dict[str, int],
                      cache_occ: Dict[str, float]) -> None:
        if not self.enabled:
            return
        for k, v in slot_counts.items():
            self.metrics.set_gauge(k, v)
        for k, v in cache_occ.items():
            self.metrics.set_gauge("cache_" + k, v)

    # ---- export -------------------------------------------------------------#
    def snapshot(self) -> dict:
        """Registry snapshot + static tags, JSON-round-trip safe."""
        return {"tags": dict(self.tags), **self.metrics.snapshot()}

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()


def _selftest() -> None:
    """Self-test: JSON round-trip + trace validity."""
    tel = Telemetry(enabled=True, tags={"family": "selftest"})
    m = tel.metrics
    m.declare_counter("dispatches")
    m.declare_gauge("occupancy")
    m.declare_histogram("latency_seconds", maxlen=8)
    m.declare_series("accept_by_slot")
    m.inc("dispatches", 3)
    m.set_gauge("occupancy", 0.5)
    m.set_gauge("occupancy", 0.25)  # peak must remember 0.5
    for i in range(20):  # overflow the reservoir: stays bounded, count exact
        m.observe("latency_seconds", 0.001 * (i + 1))
    m.append("accept_by_slot", 0, 2)

    snap = tel.snapshot()
    rt = json.loads(json.dumps(snap))
    assert rt == snap, "snapshot does not round-trip through JSON"
    assert rt["counters"]["dispatches"] == 3
    assert rt["gauges"]["occupancy"] == {"value": 0.25, "peak": 0.5}
    h = rt["histograms"]["latency_seconds"]
    assert h["count"] == 20 and abs(h["sum"] - 0.21) < 1e-9
    assert len(m.get("latency_seconds").reservoir) == 8
    assert rt["series"]["accept_by_slot"] == {"0": [2.0]}

    try:
        m.inc("typo_key")
    except UndeclaredMetric:
        pass
    else:
        raise AssertionError("undeclared metric write did not raise")

    text = tel.prometheus_text()
    assert "mra_serve_dispatches 3" in text
    assert 'mra_serve_latency_seconds{quantile="0.5"}' in text

    t = tel.trace
    t0 = tel.now()
    t.instant("submit", t0, 0)
    t.span("request", t0, t0 + 0.02, 0, {"prompt_tokens": 4})
    t.span("prefill_chunk", t0 + 0.001, t0 + 0.01, Telemetry.ENGINE_TID)
    validate_chrome_events(t.chrome_events())

    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".jsonl", delete=False) as f:
        path = f.name
    n = t.export_jsonl(path)
    loaded = load_trace_jsonl(path)
    assert len(loaded) == n and all(isinstance(e, dict) for e in loaded)
    validate_chrome_events(loaded)
    print(f"[telemetry] selftest OK: snapshot round-trips, "
          f"{n} trace events well-formed")


if __name__ == "__main__":
    _selftest()
