"""PyTorch port: the observability core against the JAX package.

The same seeded sequence of instrument calls goes into a JAX and a port
metrics registry: the Prometheus exposition is equal byte for byte and
the JSON snapshots are equal. The rings (flight recorder, sequence
timelines, step records, request spans) keep, evict and resize as the
JAX ones do; the span tracer's chrome trace has the same span tree
(names, args, nesting; times left out); the capture tracker's series
follow ``TrainStep.captures``; and the anomaly sentinel flags the cases
the JAX suite holds it to. Fresh instances are used on the JAX side (its
global registries are left alone); the port's are reset around each
test and every flag set is restored.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu.observability import flight as jax_flight  # noqa: E402
from paddle_tpu.observability import metrics as jax_metrics  # noqa: E402
from paddle_tpu.observability import reqtrace as jax_reqtrace  # noqa: E402
from paddle_tpu.observability import rotation as jax_rotation  # noqa: E402
from paddle_tpu.observability import seqtrace as jax_seqtrace  # noqa: E402
from paddle_tpu.observability import stepprof as jax_stepprof  # noqa: E402
from paddle_tpu.observability import tracer as jax_tracer  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.observability import (flight, metrics,  # noqa: E402
                                            reqtrace, rotation, seqtrace,
                                            stepprof, tracer)

_RING_FLAGS = {"serving_request_ring": 256, "flight_buffer_events": 512,
               "llm_seqtrace_ring": 256, "llm_step_ring": 256}


@pytest.fixture(autouse=True)
def _isolated():
    """The port's registries empty and its flags at their defaults, before
    and after; the JAX package's metrics switch restored."""
    jax_on = jax_metrics.enabled()
    obs.reset_all()
    try:
        yield
    finally:
        ptt.set_flags(dict(_RING_FLAGS, enable_metrics=False,
                           trace_dir="", anomaly_spike_factor=10.0,
                           recompile_warn_threshold=8))
        obs.reset_all()
        jax_metrics.set_enabled(jax_on)


@pytest.fixture
def both_on():
    """Metrics on in both packages (the JAX switch only, not its flag)."""
    ptt.set_flags({"enable_metrics": True})
    jax_metrics.set_enabled(True)
    yield


# -- the metrics registry --------------------------------------------------

def _drive(mod, reg, seed: int) -> None:
    """A seeded sequence of counter, gauge and histogram calls."""
    rng = np.random.default_rng(seed)
    tenants = ["a", "b", "default"]
    for i in range(60):
        op = int(rng.integers(0, 7))
        v = float(np.round(rng.exponential(20.0), 3))
        t = tenants[int(rng.integers(0, 3))]
        if op == 0:
            reg.counter("t_requests_total", "requests").inc(
                kind="stream", tenant=t)
        elif op == 1:
            reg.counter("t_tokens_total", "tokens").inc(int(v))
        elif op == 2:
            reg.gauge("t_depth", "queue depth").set(v, tenant=t)
        elif op == 3:
            reg.gauge("t_peak", "watermark").set_max(v)
        elif op == 4:
            reg.gauge("t_level", "level").add(-v if i % 2 else v)
        elif op == 5:
            reg.histogram("t_latency_ms", "latency",
                          buckets=mod.LATENCY_MS_BUCKETS).observe(
                              v, phase=["admit", "decode"][i % 2])
        else:
            reg.histogram("t_seconds", "default buckets").observe(v / 100)
    reg.counter("t_total_set", "set_total").set_total(7.0, where="x")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_equal_byte_for_byte(both_on, seed):
    j, p = jax_metrics.MetricsRegistry(), metrics.MetricsRegistry()
    _drive(jax_metrics, j, seed)
    _drive(metrics, p, seed)
    assert p.prometheus_text() == j.prometheus_text()
    assert p.snapshot() == j.snapshot()
    assert p.snapshot_json() == j.snapshot_json()
    for prefixes in (["t_la", "t_to"], [""], ["nothing"]):
        assert p.prometheus_text(prefixes) == j.prometheus_text(prefixes)
    c_j, c_p = j.counter("t_requests_total"), p.counter("t_requests_total")
    assert c_p.total(kind="stream") == c_j.total(kind="stream")
    h_j, h_p = j.histogram("t_latency_ms"), p.histogram("t_latency_ms")
    assert h_p.count(phase="decode") == h_j.count(phase="decode")
    assert h_p.sum(phase="decode") == h_j.sum(phase="decode")


def test_off_records_nothing_and_always_still_records():
    j, p = jax_metrics.MetricsRegistry(), metrics.MetricsRegistry()
    jax_metrics.set_enabled(False)
    for mod, reg in ((jax_metrics, j), (metrics, p)):
        reg.counter("t_gated").inc()
        reg.counter("t_always", always=True).inc(3)
        reg.histogram("t_h").observe(1.0)
    assert p.prometheus_text() == j.prometheus_text()
    assert p.counter("t_always").value() == 3
    assert p.counter("t_gated").value() == 0


def test_registry_kind_and_bucket_conflicts_raise_as_in_jax():
    for reg in (jax_metrics.MetricsRegistry(), metrics.MetricsRegistry()):
        reg.counter("t_x")
        with pytest.raises(TypeError):
            reg.gauge("t_x")
        reg.histogram("t_h", buckets=(1.0, 2.0))
        reg.histogram("t_h")  # None never conflicts
        with pytest.raises(ValueError):
            reg.histogram("t_h", buckets=(1.0, 3.0))


@pytest.mark.parametrize("seed", [3, 4])
def test_bucket_quantiles_and_percentiles_match_jax(seed):
    rng = np.random.default_rng(seed)
    vals = list(rng.exponential(30.0, 200))
    j, p = jax_metrics.MetricsRegistry(), metrics.MetricsRegistry()
    for reg, mod in ((j, jax_metrics), (p, metrics)):
        h = reg.histogram("t_q", always=True,
                          buckets=mod.LATENCY_MS_BUCKETS)
        for v in vals:
            h.observe(v)
    bj = j.snapshot()["t_q"]["series"][0]["buckets"]
    bp = p.snapshot()["t_q"]["series"][0]["buckets"]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert metrics.quantile_from_buckets(bp, q) == \
            jax_metrics.quantile_from_buckets(bj, q)
    for pct in (0, 50, 95, 100):
        assert metrics.percentile(vals, pct) == \
            jax_metrics.percentile(vals, pct)
    assert math.isnan(metrics.percentile([], 50))


def test_gauge_holds_a_tensor_without_reading_it(both_on):
    """A gauge keeps the tensor it is handed (on the card: no sync on the
    hot path) and reads it only at exposition."""
    g = obs.gauge("t_loss", "live loss")
    t = torch.tensor(2.5)
    g.set(t)
    assert g.value() is t
    assert obs.registry().snapshot()["t_loss"]["series"][0]["value"] == 2.5
    assert 't_loss 2.5' in obs.registry().prometheus_text()


# -- rotation -------------------------------------------------------------

def test_rotation_rolls_and_prunes_as_jax(tmp_path):
    for mod, sub in ((jax_rotation, "jax"), (rotation, "port")):
        d = tmp_path / sub
        path = str(d / "events.jsonl")
        for i in range(40):
            mod.append_jsonl(path, [{"i": i, "pad": "x" * 40}],
                             max_bytes=400, keep=3)
        for i in range(5):
            (d / f"flight_{i:03d}.jsonl").write_text("{}")
        mod.prune_prefixed(str(d), "flight_", keep=2)
    names = {sub: sorted(os.listdir(tmp_path / sub))
             for sub in ("jax", "port")}
    assert names["port"] == names["jax"]
    for n in names["jax"]:
        assert (tmp_path / "port" / n).read_text() == \
            (tmp_path / "jax" / n).read_text()


# -- rings ----------------------------------------------------------------

def _strip(rec):
    """A record with its clock stamps dropped (recursively)."""
    if isinstance(rec, dict):
        return {k: _strip(v) for k, v in rec.items()
                if k not in ("ts_unix", "t_mono", "begin_unix",
                             "begin_mono", "age_s", "engine")}
    if isinstance(rec, list):
        return [_strip(v) for v in rec]
    return rec


def test_flight_ring_capacity_resize_and_dump(both_on, tmp_path):
    rings = (jax_flight.FlightRecorder(10), flight.FlightRecorder(10))
    for r in rings:
        for i in range(25):
            r.record("t_step", step=i)
        assert r.capacity == 10 and len(r.events()) == 10
        r.resize(4)
        r.resize(3)  # floored to 8
    evs = [_strip(r.events()) for r in rings]
    assert evs[1] == evs[0] and [e["step"] for e in evs[0]] == \
        list(range(17, 25))
    jax_metrics.set_enabled(False)
    ptt.set_flags({"enable_metrics": False})
    for r in rings:
        r.record("t_gated")
        r.record("t_forced", force=True)
    assert [e["kind"] for e in rings[1].events()][-2:] == \
        ["t_step", "t_forced"]
    path = rings[1].dump("test", directory=str(tmp_path))
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    assert lines[0]["kind"] == "flight_header" and \
        lines[0]["events"] == 8 and lines[0]["capacity"] == 8
    assert lines[-1]["kind"] == "final_metrics" and "metrics" in lines[-1]


def test_flight_ring_follows_its_flag():
    ptt.set_flags({"flight_buffer_events": 16})
    assert flight.recorder().capacity == 16
    ptt.set_flags({"serving_request_ring": 9, "llm_seqtrace_ring": 10,
                   "llm_step_ring": 11})
    assert (reqtrace.ring().capacity, seqtrace.ring().capacity,
            stepprof.ring().capacity) == (9, 10, 11)


def _timelines(mod, ring):
    for sid in range(1, 7):
        ring.begin(sid, trace_id=100 + sid, engine=1, prompt_tokens=sid)
        ring.event(sid, "admitted", order=sid)
        for k in range(sid):
            ring.event(sid, "token", index=k)
    ring.begin(3, trace_id=999, engine=2)  # supersedes live seq 3
    for sid in (1, 2, 4, 5):
        ring.finish(sid, "finished" if sid % 2 else "error", tokens=sid)
    for k in range(mod.EVENT_CAP + 5):
        ring.event(6, "token", index=k)
    return ring


def test_seqtrace_ring_keeps_evicts_and_caps_as_jax(both_on):
    j = _timelines(jax_seqtrace, jax_seqtrace.SeqTraceRing(8))
    p = _timelines(seqtrace, seqtrace.SeqTraceRing(8))
    assert _strip(p.recent()) == _strip(j.recent())
    assert _strip(p.live()) == _strip(j.live())
    assert _strip(p.find(999)) == _strip(j.find(999))
    assert _strip(p.get(2)) == _strip(j.get(2))
    assert p.get(6)["events_dropped"] == j.get(6)["events_dropped"] > 0
    j.resize(2)
    p.resize(2)  # floored to 8
    assert _strip(p.recent()) == _strip(j.recent())
    assert len(p.recent(2)) == 2 and p.recent(0) == []


def test_stepprof_ring_keeps_and_evicts_as_jax(both_on):
    out = []
    for mod in (jax_stepprof, stepprof):
        r = mod.StepRecordRing(8)
        for i in range(12):
            r.step_begin(7, step=i, begin_unix=0.0)
            r.set_phase(7, "decode")
            live = r.live()
            r.record(7, {"step": i, "phase_ms": {"decode": 1.0 + i}})
        out.append((r.recent(), _strip(live), r.live(), r.capacity))
    assert out[1][:2] == (out[0][0], out[0][1])
    assert [x["step"] for x in out[1][0]] == list(range(4, 12))
    assert out[1][2] == [] and out[1][3] == 8


def test_reqtrace_ring_flags_anomalies_and_evicts_as_jax(both_on):
    recs = []
    for mod in (jax_reqtrace, reqtrace):
        r = mod.RequestTraceRing(8)
        for i in range(10):
            stamps = {k: 10.0 + j for j, k in enumerate(mod.STAMPS)}
            if i == 9:
                stamps["reply_unix"] = 1.0  # out of order
            r.record(dict(stamps, trace_id=i))
        recs.append((r.recent(), r.find(9), r.recent(3)))
    assert recs[1] == recs[0]
    assert recs[1][1]["anomaly"] is True and len(recs[1][0]) == 8


# -- spans ----------------------------------------------------------------

def _tree(events):
    """(name, args, depth) of each complete span, in start order; depth
    by containment of [ts, ts + dur] within a thread."""
    spans = sorted((e for e in events if e.get("ph") == "X"),
                   key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in spans:
        while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
            stack.pop()
        out.append((e["name"], e.get("args"), len(stack)))
        stack.append(e)
    return out


def _spans(mod):
    t = mod.SpanTracer()
    with t.span("step", force=True, i=1):
        with t.span("admit", force=True):
            pass
        with t.span("decode", force=True, batch=4):
            with t.span("sample", force=True):
                pass
    t.instant("marker", force=True, why="x")
    return t


def test_chrome_trace_span_tree_matches_jax():
    j, p = _spans(jax_tracer), _spans(tracer)
    tj, tp = j.chrome_trace(), p.chrome_trace()
    assert _tree(tp["traceEvents"]) == _tree(tj["traceEvents"])
    assert sorted(tp) == sorted(tj)
    inst = [(e["name"], e["args"]) for e in tp["traceEvents"]
            if e.get("ph") == "i"]
    assert inst == [("marker", {"why": "x"})]
    assert sorted(p.summary()) == sorted(j.summary())
    assert p.summary()["step"]["calls"] == 1


def test_spans_off_record_nothing_and_export_all_writes(tmp_path):
    with obs.span("t_off"):
        pass
    assert obs.get_tracer().events() == []
    ptt.set_flags({"enable_metrics": True})
    with obs.span("t_on", k=2):
        obs.counter("t_c", "c").inc()
    out = obs.export_all(str(tmp_path))
    trace = json.load(open(out["trace"]))
    assert [e["name"] for e in trace["traceEvents"]
            if e.get("ph") == "X"] == ["t_on"]
    snap = json.load(open(out["metrics"]))
    assert snap["metrics"]["t_c"]["series"][0]["value"] == 1
    assert "t_c 1" in open(out["prometheus"]).read()
    obs.reset_all()
    assert obs.registry().names() == [] and obs.get_tracer().events() == []


def test_span_opens_a_profiler_range():
    """A span is a torch.profiler.record_function: under the profiler
    it shows on the timeline."""
    ptt.set_flags({"enable_metrics": True})
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("t_profiled_span"):
            torch.ones(4).sum()
    assert any(e.key == "t_profiled_span" for e in prof.key_averages())


def test_device_memory_stats_and_observe_traced_on_the_cpu():
    assert obs.device_memory_stats() == {}
    assert obs.device_memory_stats(include_unavailable=True,
                                   full=True) == {
        "cpu": {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                "bytes_limit": 0}}
    obs.observe_traced("t_gnorm", torch.tensor(1.5))
    assert obs.registry().get("t_gnorm") is None  # metrics off
    ptt.set_flags({"enable_metrics": True})
    obs.observe_traced("t_gnorm", torch.tensor(1.5))
    obs.observe_traced("t_count", torch.tensor(2.0), kind="counter")
    assert float(obs.gauge("t_gnorm").value()) == 1.5
    assert obs.counter("t_count").value() == 2.0
    from paddle_tpu_torch import native
    assert obs.native_stats() == (native.stat_dump() if native.loaded()
                                  else {})


# -- the anomaly sentinel (the JAX suite's cases) ---------------------------

def test_anomaly_sentinel_nan_and_spike(tmp_path):
    ptt.set_flags({"enable_metrics": True, "trace_dir": str(tmp_path)})
    s = obs.anomaly_sentinel()
    assert s.observe("t_loss", float("nan")) == "nan"
    for _ in range(8):                      # warmup around ~1.0
        assert s.observe("t_loss", 1.0) is None
    assert s.observe("t_loss", 1e6) == "spike"
    c = obs.counter("anomalies_total")
    assert c.value(kind="nan", series="t_loss") == 1
    assert c.value(kind="spike", series="t_loss") == 1
    lines = [json.loads(x) for x in
             open(tmp_path / "events.jsonl").read().splitlines()]
    assert [e["kind"] for e in lines] == ["nan", "spike"]
    assert lines[1]["series"] == "t_loss" and "ewma" in lines[1]


@pytest.mark.parametrize("factor", [0.0, 10.0])
def test_sentinel_verdicts_match_jax_over_a_seeded_series(factor):
    """Both sentinels see the same series (warmup, noise, NaN, spikes);
    every verdict is the same, and so is the divergence watchdog's."""
    from paddle_tpu.flags import GLOBAL_FLAGS as JAX_FLAGS
    from paddle_tpu.observability import anomaly as jax_anomaly
    rng = np.random.default_rng(5)
    series = list(1.0 + 0.05 * rng.standard_normal(40))
    series[3] = float("nan")
    series[12] = 50.0
    series[20:26] = [float("inf")] * 6
    series[30] = -80.0
    prev = JAX_FLAGS.get("anomaly_spike_factor")
    JAX_FLAGS.set("anomaly_spike_factor", factor)
    ptt.set_flags({"anomaly_spike_factor": factor})
    try:
        verdicts = []
        for mod in (jax_anomaly, obs.anomaly):
            s = mod.AnomalySentinel()
            wd = mod.DivergenceWatchdog(series=("t",), streak=5).attach(s)
            verdicts.append(([s.observe("t", v) for v in series],
                             wd.tripped()))
    finally:
        JAX_FLAGS.set("anomaly_spike_factor", prev)
    assert verdicts[1] == verdicts[0]
    assert verdicts[1][1] is True
    assert verdicts[1][0][12] == ("spike" if factor else None)


def test_sentinel_listener_errors_stay_isolated():
    s = obs.anomaly.AnomalySentinel()
    seen = []

    def bad(series, value, kind):
        raise RuntimeError("broken consumer")

    s.add_listener(bad)
    s.add_listener(lambda *a: seen.append(a))
    assert s.observe("t", float("nan")) == "nan"
    assert len(seen) == 1 and seen[0][0] == "t" and seen[0][2] == "nan" \
        and math.isnan(seen[0][1])


# -- the capture tracker --------------------------------------------------

class _Graph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _EagerGraphs:
    """The captured step's backend on the CPU: the warm-up runs the step,
    the capture keeps the body, a replay runs it."""

    def warm_up(self, fn):
        return fn()

    def capture(self, fn, generator=None, table_rows=0):
        return _Graph(fn), []


def test_capture_tracker_follows_train_step_captures():
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.ops.loss import cross_entropy
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.static import TrainStep
    ptt.set_flags({"enable_metrics": True, "recompile_warn_threshold": 3})
    torch.manual_seed(0)
    step = TrainStep(Linear(4, 2, device="cpu"), Adam(0.01),
                     lambda o, y: cross_entropy(o, y))
    step.compiled, step._backend = True, _EagerGraphs()
    y = torch.tensor([0, 1, 1, 0, 1])
    shapes = [5, 5, 5, 3, 3, 5, 4]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for n in shapes:
            step(torch.randn(n, 4), labels=y[:n])
    assert step.captures == 3
    rec = obs.recompile_tracker().get("TrainStep(Linear)").stats()
    assert rec["traces"] == 3 and rec["hits"] == len(shapes) - 3
    assert rec["signatures"][0] == "(float32[5, 4],int64[5])"
    assert obs.counter("jit_traces_total").value(
        fn="TrainStep(Linear)") == step.captures
    assert obs.counter("jit_cache_hits_total").value(
        fn="TrainStep(Linear)") == len(shapes) - 3
    assert obs.histogram("jit_compile_seconds").count(
        fn="TrainStep(Linear)") == 3
    assert obs.counter("optimizer_steps_total").value() == len(shapes)
    storms = [x for x in w if "recompilation storm" in str(x.message)]
    assert len(storms) == 1
    kinds = [e["kind"] for e in obs.flight_recorder().events()]
    assert kinds.count("recompile") == 3
    names = [e["name"] for e in obs.get_tracer().events()]
    assert names == ["TrainStep(Linear)"] * len(shapes)
