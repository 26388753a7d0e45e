"""PyTorch port: the live HTTP exporter, trace aggregation and the
profiler shim against the JAX package.

The JAX suite's exporter tests run against the port case for case
(``/healthz`` ok and wedged, ``/trace``, 404, ``/goodput`` + ``/flight``,
port semantics, ``/alerts`` + ``/slo`` + ``?name=``, the LLM flight deck,
scrapes during training, the self-test), then: the ``/metrics`` pages of
both exporters are byte-equal for the same registry content,
``trace_agg.span_summary`` is equal over the same trace file, the device
roll-up reads the CUDA kernel lane of a ``torch.profiler`` trace, and
``inference.Server`` brings the exporter up and bridges the native
transport's stats. Every exporter started here is stopped in teardown;
ports are ephemeral; both packages' ``metrics_port`` and
``enable_metrics`` are restored.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import gzip
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import observability as jax_obs  # noqa: E402
from paddle_tpu.observability import metrics as jax_metrics  # noqa: E402
from paddle_tpu.observability import server as jax_server  # noqa: E402
from paddle_tpu.observability import trace_agg as jax_trace_agg  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch import profiler  # noqa: E402
from paddle_tpu_torch.observability import server as obs_server  # noqa: E402
from paddle_tpu_torch.observability import trace_agg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _isolated():
    jax_on = jax_metrics.enabled()
    # both registries start empty: a test file run earlier in this
    # process may have left instruments in either
    obs.reset_all()
    jax_obs.reset_all()
    try:
        yield
    finally:
        ptt.set_flags({"enable_metrics": False, "metrics_port": 0,
                       "trace_dir": "", "health_heartbeat_timeout_s": 300.0,
                       "stack_sample_hz": 0.0})
        pt.set_flags({"enable_metrics": False, "metrics_port": 0})
        obs_server.stop()
        obs.reset_all()
        jax_obs.reset_all()
        jax_metrics.set_enabled(jax_on)


@pytest.fixture
def http_server():
    ptt.set_flags({"enable_metrics": True})
    srv = obs_server.start(0)
    yield srv


def _get(port, path, timeout=10):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- /metrics against the JAX exporter ----------------------------------------------

def _drive(mod, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for i in range(50):
        op = int(rng.integers(0, 4))
        v = float(np.round(rng.exponential(20.0), 3))
        t = ["a", "b", "default"][int(rng.integers(0, 3))]
        if op == 0:
            mod.counter("t_x_requests_total", "requests").inc(kind="s",
                                                              tenant=t)
        elif op == 1:
            mod.gauge("t_x_depth", "queue depth").set(v, tenant=t)
        elif op == 2:
            mod.histogram("t_x_latency_ms", "latency",
                          buckets=mod.metrics.LATENCY_MS_BUCKETS).observe(
                              v, phase=["admit", "decode"][i % 2])
        else:
            mod.counter("t_x_tokens_total", "tokens").inc(int(v))


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_pages_byte_equal_jax(monkeypatch, seed):
    """The same instrument calls into both packages' registries: the
    exporters' /metrics bodies (and the ?name= filtered ones) are equal
    byte for byte, native stats bridged alike."""
    native = {"serving.accepted": 7, "serving.draining": 0}
    monkeypatch.setattr(obs, "native_stats", lambda: dict(native))
    monkeypatch.setattr(jax_server, "_native_stats", lambda: dict(native))
    ptt.set_flags({"enable_metrics": True})
    pt.set_flags({"enable_metrics": True, "metrics_port": -1})
    _drive(obs, seed)
    _drive(jax_obs, seed)
    jsrv = jax_server.ObservabilityServer(0)
    psrv = obs_server.ObservabilityServer(0)
    try:
        pages = {}
        for path in ("/metrics", "/metrics?name=t_x_lat,pt_native",
                     "/metrics?name=t_x_requests_total"):
            pages[path] = _get(psrv.port, path)
            assert pages[path] == _get(jsrv.port, path), path
        assert 'pt_native_stat{name="serving.accepted"} 7' \
            in pages["/metrics"][1]
        assert "pt_native" not in pages["/metrics?name=t_x_requests_total"][1]
        assert obs_server.metrics_text() == jax_server.metrics_text()
    finally:
        jsrv.stop()
        psrv.stop()


# -- the JAX suite's endpoint cases ---------------------------------------------------

def test_healthz_ok_and_wedged(http_server):
    code, text = _get(http_server.port, "/healthz")
    body = json.loads(text)
    assert code == 200 and body["status"] == "ok"
    assert body["devices"] == (["cpu"] if not torch.cuda.is_available()
                               else body["devices"])
    obs.gauge(obs_server.HEARTBEAT_GAUGE).set(time.time() - 10_000)
    code, text = _get(http_server.port, "/healthz")
    body = json.loads(text)
    assert code == 503 and body["wedged"] is True, body
    obs.gauge(obs_server.HEARTBEAT_GAUGE).set(time.time())
    assert _get(http_server.port, "/healthz")[0] == 200


def test_healthz_heartbeat_timeout_flag(http_server):
    obs.gauge(obs_server.HEARTBEAT_GAUGE).set(time.time() - 5.0)
    ptt.set_flags({"health_heartbeat_timeout_s": 1.0})
    assert _get(http_server.port, "/healthz")[0] == 503
    ptt.set_flags({"health_heartbeat_timeout_s": 0.0})  # check off
    assert _get(http_server.port, "/healthz")[0] == 200


def test_trace_window_endpoint(http_server):
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            with obs.span("windowed"):
                pass

    th = threading.Thread(target=spin, daemon=True)
    th.start()
    try:
        code, text = _get(http_server.port, "/trace?ms=100")
    finally:
        stop.set()
        th.join(timeout=5)
    trace = json.loads(text)
    assert code == 200 and trace["metadata"]["window_ms"] == 100
    assert any(e.get("name") == "windowed" for e in trace["traceEvents"])


def test_unknown_path_404_and_index(http_server):
    assert _get(http_server.port, "/nope")[0] == 404
    code, text = _get(http_server.port, "/")
    assert code == 200 and "/fleet/stacks /router" in text


def test_goodput_and_flight_endpoints(http_server):
    led = obs.goodput_ledger()
    led.start()
    try:
        led.attribute("step_compute", 0.3)
        led.attribute("data_wait", 0.1)
        obs.flight.record("probe_event", step=4)
        gp = json.loads(_get(http_server.port, "/goodput")[1])
        assert gp["buckets"]["step_compute"] == pytest.approx(0.3)
        assert set(gp["buckets"]) == set(obs.goodput.BUCKETS)
        assert sum(gp["ratios"].values()) == pytest.approx(1.0, abs=1e-6)
        fl = json.loads(_get(http_server.port, "/flight")[1])
        assert fl["capacity"] >= 8
        assert any(e["kind"] == "probe_event" for e in fl["events"])
    finally:
        led.stop()


def test_metrics_port_semantics():
    ptt.set_flags({"enable_metrics": True, "metrics_port": -1})
    assert obs_server.maybe_start() is None
    ptt.set_flags({"metrics_port": 0})
    srv = obs_server.maybe_start()
    assert srv is not None and srv.port > 0
    assert obs.gauge("observability_server_port").value() == srv.port
    assert obs_server.start(srv.port + 1) is srv
    assert obs_server.maybe_start() is srv
    # maybe_start brought up the judgment layer and the hang monitor
    names = [t.name for t in threading.enumerate()]
    assert "pt-tsdb-sampler" in names and "pt-hang-monitor" in names
    assert obs_server.get() is srv
    obs_server.stop()
    assert obs_server.get() is None


def test_alerts_and_slo_endpoints(http_server):
    from paddle_tpu_torch.observability import slo, tsdb
    slo.ensure_default_pack()
    obs.counter("serving_stream_requests_total", "h").inc(4)
    tsdb.sample_once()
    tsdb.sample_once()
    body = json.loads(_get(http_server.port, "/alerts")[1])
    names = {a["slo"] for a in body["alerts"]}
    assert {"serving_availability", "serving_ttft_p99",
            "kv_audit_clean"} <= names
    assert body["worst_state"] == "inactive"
    assert body["transition_cap"] == 256 and "capacity" in body["tsdb"]
    body = json.loads(_get(http_server.port, "/slo")[1])
    assert [p["pair"] for p in body["window_pairs"]] == ["fast", "slow"]
    avail = next(s for s in body["slos"]
                 if s["spec"]["name"] == "serving_availability")
    assert avail["lifetime"]["total"] == 4.0
    assert avail["lifetime"]["compliance"] == 1.0
    code, text = _get(http_server.port, "/metrics?name=slo_")
    assert code == 200 and "slo_alert_state" in text
    assert "serving_stream_requests_total" not in text
    samples = [ln for ln in text.splitlines() if ln and ln[0] != "#"]
    assert samples and all(ln.startswith("slo_") for ln in samples)


def test_llm_flight_deck_endpoints(http_server):
    from paddle_tpu_torch.observability import seqtrace, stepprof
    seqtrace.begin(7, trace_id=0xFEED, engine=1, prompt_tokens=3)
    seqtrace.event(7, "token", index=0)
    seqtrace.finish(7, "finished", tokens=1)
    seqtrace.begin(8, trace_id=0xBEEF, engine=1, prompt_tokens=2)
    stepprof.ring().step_begin(1, step=3, begin_unix=0.0)
    stepprof.ring().record(1, {"step": 3, "dur_ms": 2.5, "begin_mono": 0.0,
                               "phase_ms": {"decode": 2.0}})
    stepprof.ring().step_begin(1, step=4, begin_unix=0.0)
    body = json.loads(_get(http_server.port, "/llm/seqs")[1])
    assert [t["seq_id"] for t in body["live"]] == [8]
    assert [t["seq_id"] for t in body["finished"]] == [7]
    body = json.loads(_get(http_server.port,
                           f"/llm/seqs?trace_id={0xFEED}")[1])
    assert int(body["trace_id"]) == 0xFEED
    assert [e["ev"] for e in body["timelines"][0]["events"]] \
        == ["queued", "token", "finished"]
    body = json.loads(_get(http_server.port, "/llm/steps")[1])
    assert [r["step"] for r in body["steps"]] == [3]
    assert [r["step"] for r in body["live"]] == [4]
    obs.reqtrace.record({"trace_id": 5, "ingress_unix": time.time(),
                         "reply_unix": time.time()})
    body = json.loads(_get(http_server.port, "/requests?n=3")[1])
    assert any(r.get("trace_id") == 5 for r in body["requests"])


def test_varz_reads_torch_not_jax(http_server):
    varz = json.loads(_get(http_server.port, "/varz")[1])
    assert varz["versions"]["torch"] == torch.__version__
    assert "jax" not in varz["versions"]
    assert set(varz) >= {"metrics", "recompile", "programs",
                         "device_memory", "native_stats", "health", "flags"}
    assert varz["flags"]["metrics_port"] == 0
    assert varz["device_memory"] == obs.device_memory_stats(
        include_unavailable=True, full=True)


def test_export_all_writes_every_section(tmp_path):
    ptt.set_flags({"enable_metrics": True})
    obs.counter("t_export_total").inc(2)
    out = obs.export_all(str(tmp_path))
    prom = open(out["prometheus"]).read()
    assert "t_export_total 2" in prom
    assert prom == obs_server.metrics_text()
    snap = json.load(open(out["metrics"]))
    assert set(snap) >= {"metrics", "recompile", "programs", "goodput",
                         "alerts", "tsdb", "native_stats"}


def test_exporter_self_test_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.observability.server",
         "--self-test"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "self-test OK" in proc.stdout


def test_concurrent_scrapes_during_training():
    """/metrics and /varz hammered from threads while a TrainStep loop
    mutates the registry: every scrape 200 and parseable."""
    from paddle_tpu_torch.models import (BertConfig, BertForPretraining,
                                         pretraining_loss)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    ptt.set_flags({"enable_metrics": True})
    srv = obs_server.ObservabilityServer(0)
    stop = threading.Event()
    results = {"/metrics": [], "/varz": []}
    errors = []
    prom_line = re.compile(r"^[a-zA-Z_:][\w:.]*(\{.*\})? \S+$")

    def scrape(path):
        while not stop.is_set():
            try:
                code, body = _get(srv.port, path)
                if path == "/metrics":
                    bad = [ln for ln in body.splitlines()
                           if ln and ln[0] != "#" and not prom_line.match(ln)]
                    assert not bad, bad[:3]
                else:
                    json.loads(body)
                results[path].append(code)
            except Exception as e:  # noqa: BLE001 — the assertion below
                errors.append(f"{path}: {type(e).__name__}: {e}")
                return

    threads = [threading.Thread(target=scrape, args=(p,), daemon=True)
               for p in ("/metrics", "/metrics", "/varz", "/varz")]
    for t in threads:
        t.start()
    try:
        cfg = BertConfig(vocab_size=128, hidden_size=32,
                         num_hidden_layers=1, num_attention_heads=2,
                         intermediate_size=64, max_position_embeddings=32)
        step = TrainStep(BertForPretraining(cfg, device="cpu"), AdamW(1e-3),
                         pretraining_loss)
        rng = np.random.default_rng(0)
        for i in range(6):
            ids = torch.from_numpy(rng.integers(0, 128, (2, 16)))
            step(ids, labels=(torch.from_numpy(rng.integers(0, 128, (2, 16))),
                              torch.from_numpy(rng.integers(0, 2, (2,)))))
            obs.gauge(obs_server.HEARTBEAT_GAUGE).set(time.time())
        while min(len(v) for v in results.values()) < 2 and not errors:
            stop.wait(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        srv.stop()
    assert not errors, errors
    assert all(c == 200 for v in results.values() for c in v)
    assert all(not t.is_alive() for t in threads)


# -- the server hooks --------------------------------------------------------------

def test_inference_server_starts_the_exporter_and_bridges_stats():
    from paddle_tpu_torch import inference
    ptt.set_flags({"enable_metrics": True})
    srv = inference.Server(None, stats_interval_s=0.05)
    try:
        exporter = obs_server.get()
        assert exporter is not None
        stats = srv.scrape_stats()
        assert stats["queue_cap"] == 512
        assert obs.gauge("serving_queue_cap").value() == 512.0
        assert obs.counter("serving_accepted_total").value() \
            == float(stats["accepted_total"])
        text = _get(exporter.port, "/metrics?name=serving_")[1]
        assert "serving_queue_cap 512.0" in text
    finally:
        srv.stop()
    assert not srv._bridge.is_alive()


def test_router_endpoint_lists_live_routers(http_server):
    from paddle_tpu_torch.serving_llm import router as prouter
    r = prouter.Router([("127.0.0.1", 9), ("127.0.0.1", 10)],
                       start_probes=False).start()
    try:
        body = json.loads(_get(http_server.port, "/router")[1])
        assert [x["addr"] for x in body["routers"]] == [r.addr]
        assert len(body["routers"][0]["backends"]) == 2
        assert prouter.snapshot_all() == body["routers"]
    finally:
        r.stop()
    assert json.loads(_get(http_server.port, "/router")[1]) \
        == {"routers": []}


# -- trace aggregation -----------------------------------------------------------

def _kineto_events():
    """A torch.profiler chrome trace's shape: CPU ops and runtime calls
    on the host, CUDA kernels and a memcpy on a stream, step
    annotations."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1",
         "pid": 1, "tid": 1, "ts": 0, "dur": 900.0},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#2",
         "pid": 1, "tid": 1, "ts": 1000, "dur": 900.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1,
         "ts": 10, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 20, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel", "pid": 0,
         "tid": 7, "ts": 30, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel", "pid": 0,
         "tid": 7, "ts": 1030, "dur": 120.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
         "tid": 7, "ts": 200, "dur": 30.0},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]


def test_device_rollup_reads_the_cuda_kernel_lane():
    r = trace_agg.xla_op_rollup(_kineto_events())
    assert r["ops"]["flash_fwd_kernel"] == {"dur_us": 220.0, "count": 2}
    assert r["categories"] == {"kernel": 220.0, "gpu_memcpy": 30.0}
    assert r["total_us"] == 250.0 and r["steps"] == 2
    text = trace_agg.format_xla_rollup(r, top=5)
    assert "flash_fwd_kernel" in text and "ms/step" in text


def test_device_rollup_refuses_a_trace_without_kernels():
    events = [e for e in _kineto_events()
              if e.get("cat") not in trace_agg.DEVICE_CATEGORIES]
    with pytest.raises(trace_agg.TraceFormatError):
        trace_agg.xla_op_rollup(events)


@pytest.mark.parametrize("gz", [False, True])
def test_span_summary_equals_jax_over_the_same_file(tmp_path, gz):
    rng = np.random.default_rng(int(gz))
    events = [{"ph": "X", "name": f"span{int(rng.integers(0, 4))}",
               "ts": float(i), "dur": float(np.round(rng.exponential(30), 3))}
              for i in range(40)] + _kineto_events()
    path = tmp_path / ("t.trace.json.gz" if gz else "t.trace.json")
    data = json.dumps({"traceEvents": events})
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    got = trace_agg.load_trace_events(str(path))
    assert got == jax_trace_agg.load_trace_events(str(path))
    s = trace_agg.span_summary(got, prefix="host::")
    assert s == jax_trace_agg.span_summary(got, prefix="host::")
    assert trace_agg.format_span_table(s, top=5) \
        == jax_trace_agg.format_span_table(s, top=5)
    assert trace_agg.find_xla_traces(str(tmp_path)) == [str(path)]


# -- the profiler shim ----------------------------------------------------------------

def test_profiler_record_event_summary_and_stats():
    profiler.reset_host_events()
    with profiler.RecordEvent("compat_span"):
        pass
    events = profiler.get_host_events()
    assert events and events[0]["name"] == "compat_span"
    assert profiler.event_summary()["compat_span"]["calls"] == 1
    profiler.reset_host_events()
    profiler.stat_add("t_compat_stat", 3)
    profiler.stat_add("t_compat_stat")
    assert profiler.stats.get("t_compat_stat") == 4
    profiler.stats.set("t_compat_stat", 10)
    assert profiler.stats.snapshot()["t_compat_stat"] == 10


def test_profiler_step_timer():
    t = profiler.StepTimer(items_per_step=8)
    assert t.stop() == 0.0 and t.times == []
    t.times = [10.0]
    assert t.throughput(skip_first=1) == 0.0
    t.times = [10.0, 1.0, 1.0]
    assert t.throughput(skip_first=1) == pytest.approx(8.0)
    x = torch.ones(3)
    assert profiler.benchmark_sync({"a": [x]}) == {"a": [x]}


def test_profiler_capture_writes_a_trace_the_rollup_reads(tmp_path):
    with profiler.profiler(str(tmp_path)):
        with profiler.RecordEvent("profiled"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    path = tmp_path / profiler.TRACE_FILE
    events = trace_agg.load_trace_events(str(path))
    assert any(e.get("name") == "profiled" for e in events)
    assert trace_agg.find_xla_traces(str(tmp_path)) == [str(path)]
    # a CPU-only capture has no kernel lane
    with pytest.raises(trace_agg.TraceFormatError):
        trace_agg.xla_op_rollup(events)
