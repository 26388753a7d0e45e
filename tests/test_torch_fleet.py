"""PyTorch port: fleet federation against the JAX package.

The JAX suite's federation tests run against the port case for case
(merge rules, the aggregator and its ``/fleet*`` endpoints, the push
reporter, env discovery), then: the same per-host snapshots merge to the
same fleet snapshot and Prometheus text in both packages, a port
worker's push merges into a JAX aggregator and a JAX worker's push into a
port one, with equal ``/fleet`` pages. Every exporter and reporter
started here is stopped in teardown; ports are ephemeral.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import observability as jax_obs  # noqa: E402
from paddle_tpu.observability import fleet as jax_fleet  # noqa: E402
from paddle_tpu.observability import metrics as jax_metrics  # noqa: E402
from paddle_tpu.observability import server as jax_server  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.observability import fleet  # noqa: E402
from paddle_tpu_torch.observability import server as obs_server  # noqa: E402


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
                       "fleet_stale_after_s": 15.0,
                       "fleet_push_interval_s": 2.0})
        pt.set_flags({"enable_metrics": False, "metrics_port": 0})
        fleet.stop_reporter()
        obs_server.stop()
        obs.reset_all()
        jax_obs.reset_all()
        jax_metrics.set_enabled(jax_on)


@pytest.fixture
def metrics_on():
    ptt.set_flags({"enable_metrics": True})
    yield


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _counter_snap(value, **labels):
    return {"type": "counter", "help": "h",
            "series": [{"labels": labels, "value": value}]}


def _hist_snap(buckets, count, total):
    return {"type": "histogram", "help": "",
            "series": [{"labels": {}, "count": count, "sum": total,
                        "buckets": dict(buckets)}]}


# -- merge semantics --------------------------------------------------------------

def test_merge_counters_summed_per_label_set():
    merged = fleet.merge_metric_snapshots({
        "a": {"reqs_total": _counter_snap(3)},
        "b": {"reqs_total": _counter_snap(4)},
        "c": {"reqs_total": _counter_snap(5, route="x")}})
    series = {tuple(sorted(s["labels"].items())): s["value"]
              for s in merged["reqs_total"]["series"]}
    assert series == {(): 7, (("route", "x"),): 5}


def test_merge_gauges_get_host_label():
    merged = fleet.merge_metric_snapshots({
        h: {"loss": {"type": "gauge", "help": "",
                     "series": [{"labels": {}, "value": v}]}}
        for h, v in (("a", 1.0), ("b", 2.0))})
    assert {s["labels"]["host"]: s["value"]
            for s in merged["loss"]["series"]} == {"a": 1.0, "b": 2.0}


def test_merge_histograms_bucketwise_exact():
    merged = fleet.merge_metric_snapshots({
        "a": {"lat_ms": _hist_snap({"1.0": 1, "5.0": 2, "+Inf": 3}, 3, 4.5)},
        "b": {"lat_ms": _hist_snap({"1.0": 0, "5.0": 4, "+Inf": 4}, 4, 9.0)}})
    s = merged["lat_ms"]["series"][0]
    assert s["buckets"] == {"1.0": 1, "5.0": 6, "+Inf": 7}
    assert s["count"] == 7 and s["sum"] == 13.5


@pytest.mark.parametrize("a, b, match", [
    (_hist_snap({"1.0": 1, "+Inf": 1}, 1, 0.5),
     _hist_snap({"2.0": 1, "+Inf": 1}, 1, 0.5), "bucket boundaries differ"),
    (_counter_snap(1), {"type": "gauge", "help": "",
                        "series": [{"labels": {}, "value": 1.0}]},
     "counter.*gauge|gauge.*counter")])
def test_merge_mismatch_raises_as_jax(a, b, match):
    for mod in (fleet, jax_fleet):
        with pytest.raises(ValueError, match=match):
            mod.merge_metric_snapshots({"a": {"x": a}, "b": {"x": b}})


def test_merged_prometheus_text_renders_all_kinds():
    merged = fleet.merge_metric_snapshots({"a": {
        "c_total": _counter_snap(2),
        "g": {"type": "gauge", "help": "gh",
              "series": [{"labels": {}, "value": 7.0}]},
        "h_ms": _hist_snap({"1.0": 1, "+Inf": 2}, 2, 3.0)}})
    text = fleet.merged_prometheus_text(merged)
    for want in ("c_total 2", 'g{host="a"} 7.0', 'h_ms_bucket{le="1.0"} 1',
                 "h_ms_count 2"):
        assert want in text


def _seeded_hosts(seed: int) -> dict:
    """Per-host registry snapshots from a seeded sequence, taken from the
    JAX package's own registry type (the push body's ``metrics``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for host in ("w0", "w1", "w2"):
        reg = jax_metrics.MetricsRegistry()
        for _ in range(30):
            op = int(rng.integers(0, 3))
            t = ["a", "b"][int(rng.integers(0, 2))]
            if op == 0:
                reg.counter("t_f_total", "h", always=True).inc(
                    int(rng.integers(1, 9)), tenant=t)
            elif op == 1:
                reg.gauge("t_f_depth", "g", always=True).set(
                    float(rng.integers(0, 50)), tenant=t)
            else:
                reg.histogram("t_f_ms", "h", always=True,
                              buckets=jax_metrics.LATENCY_MS_BUCKETS
                              ).observe(float(rng.exponential(30.0)))
        out[host] = reg.snapshot()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_equals_jax(seed):
    hosts = _seeded_hosts(seed)
    got = fleet.merge_metric_snapshots(json.loads(json.dumps(hosts)))
    want = jax_fleet.merge_metric_snapshots(json.loads(json.dumps(hosts)))
    assert got == want
    assert fleet.merged_prometheus_text(got) \
        == jax_fleet.merged_prometheus_text(want)


def test_local_snapshot_has_the_jax_shape(metrics_on):
    jax_metrics.set_enabled(True)
    assert set(fleet.local_snapshot("h")) \
        == set(jax_fleet.local_snapshot("h"))


# -- aggregator, endpoints, reporter ---------------------------------------------

def test_aggregator_ingest_and_fleet_endpoints(metrics_on):
    srv = obs_server.start(0)
    obs.counter("t_fed_total").inc(2)
    obs.gauge("t_fed_gauge").set(0.5)
    rep = fleet.FleetReporter(f"127.0.0.1:{srv.port}", host_id="hA",
                              interval_s=60)
    try:
        assert rep.push_once()
        fleet.aggregator().ingest(fleet.local_snapshot("hB"))
        code, text = _get(srv.port, "/fleet")
        assert code == 200
        assert "t_fed_total 4" in text, text
        assert 't_fed_gauge{host="hA"} 0.5' in text
        view = json.loads(_get(srv.port, "/fleet?format=json")[1])
        assert view["n_hosts"] == 2 and set(view["hosts"]) == {"hA", "hB"}
        assert "merge_error" not in view
        code, body = _get(srv.port, "/fleet/health")
        health = json.loads(body)
        assert code == 200 and not health["hosts"]["hA"]["stale"]
        assert health["hosts"]["hA"]["port"] == srv.port
        gp = json.loads(_get(srv.port, "/fleet/goodput")[1])
        assert set(gp["hosts"]) == {"hA", "hB"}
        assert "step_compute" in gp["buckets"]
        code, body = _get(srv.port, "/fleet/stacks")
        fs = json.loads(body)
        assert code == 200 and fs["hosts"]["hA"]["error"] is None
        assert any(t["name"] == "MainThread"
                   for t in fs["hosts"]["hA"]["stacks"]["threads"])
    finally:
        rep.stop()
    assert not rep._thread.is_alive()


def test_fleet_health_stale_flips_503(metrics_on):
    srv = obs_server.start(0)
    fleet.aggregator().ingest(fleet.local_snapshot("dead-host"))
    ptt.set_flags({"fleet_stale_after_s": 0.05})
    time.sleep(0.1)
    code, body = _get(srv.port, "/fleet/health")
    assert code == 503 and json.loads(body)["hosts"]["dead-host"]["stale"]
    code, body = _get(srv.port, "/fleet?format=json")
    assert code == 200 and json.loads(body)["n_hosts"] == 1


def test_fleet_push_rejects_garbage(metrics_on):
    srv = obs_server.start(0)
    for data in (b"not json", json.dumps({"metrics": {}}).encode()):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/fleet/push", data=data,
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 400


def test_fleet_alerts_merge_worst_state_and_staleness(metrics_on):
    from paddle_tpu_torch.observability import slo
    srv = obs_server.start(0)
    slo.ensure_default_pack()
    fleet.aggregator().ingest(fleet.local_snapshot("hA"))
    snap = fleet.local_snapshot("hB")
    snap["alerts"] = {"worst_state": "firing", "alerts": [
        {"slo": "serving_availability", "state": "firing",
         "trigger_pair": "fast", "budget_remaining": -3.0, "age_s": 1.0},
        {"slo": "kv_audit_clean", "state": "pending",
         "budget_remaining": 1.0, "age_s": 0.5}]}
    fleet.aggregator().ingest(snap)
    view = json.loads(_get(srv.port, "/fleet/alerts")[1])
    assert view["worst_state"] == "firing"
    assert view["n_hosts"] == 2 and view["n_reporting"] == 2
    avail = view["slos"]["serving_availability"]
    assert avail["state"] == "firing" and avail["firing_hosts"] == ["hB"]
    assert avail["hosts"]["hA"]["state"] == "inactive"
    assert avail["hosts"]["hB"]["trigger_pair"] == "fast"
    assert view["slos"]["kv_audit_clean"]["state"] == "pending"
    ptt.set_flags({"fleet_stale_after_s": 0.05})
    time.sleep(0.1)
    fleet.aggregator().ingest(fleet.local_snapshot("hA"))
    view = fleet.fleet_alerts()
    assert view["stale_hosts"] == ["hB"] and view["n_reporting"] == 1
    assert view["worst_state"] == "inactive"
    assert view["slos"]["serving_availability"]["hosts"]["hB"]["stale"]


def test_reporter_survives_dead_aggregator(metrics_on):
    rep = fleet.FleetReporter("127.0.0.1:9", host_id="w", interval_s=60)
    try:
        c = obs.counter("fleet_push_failures_total", always=True)
        before = c.value()
        assert rep.push_once(timeout_s=0.5) is False
        assert c.value() == before + 1
    finally:
        rep.stop()


def test_merge_error_degrades_readable(metrics_on):
    srv = obs_server.start(0)
    for host, bound in (("mA", "1.0"), ("mB", "2.0")):
        snap = fleet.local_snapshot(host)
        snap["metrics"] = {"bad_ms": _hist_snap({bound: 1, "+Inf": 1},
                                                1, 0.5)}
        fleet.aggregator().ingest(snap)
    view = json.loads(_get(srv.port, "/fleet?format=json")[1])
    assert "bucket boundaries differ" in view.get("merge_error", "")
    assert set(view["per_host_metrics"]) == {"mA", "mB"}


def test_maybe_start_reporter_from_env(metrics_on, monkeypatch):
    srv = obs_server.start(0)
    monkeypatch.setenv(fleet.AGGREGATOR_ENV, f"127.0.0.1:{srv.port}")
    monkeypatch.setenv(fleet.HOST_ENV, "env-worker")
    ptt.set_flags({"fleet_push_interval_s": 30.0})
    assert obs_server.maybe_start() is srv
    assert fleet.reporter() is not None
    assert fleet.reporter().host_id == "env-worker"
    assert fleet.reporter().push_once()
    assert "env-worker" in fleet.aggregator().hosts()
    assert (fleet.AGGREGATOR_ENV, fleet.HOST_ENV) \
        == (jax_fleet.AGGREGATOR_ENV, jax_fleet.HOST_ENV)


# -- across the packages -----------------------------------------------------------

def _fill(mod) -> None:
    mod.counter("t_xfed_total", "h").inc(3, kind="a")
    mod.counter("t_xfed_total", "h").inc(2, kind="b")
    mod.gauge("t_xfed_depth", "g").set(4.5)
    h = mod.histogram("t_xfed_ms", "h",
                      buckets=mod.metrics.LATENCY_MS_BUCKETS)
    for v in (0.3, 7.0, 42.0, 900.0):
        h.observe(v)


def test_pushes_merge_across_the_packages(metrics_on):
    """A port worker pushes to a JAX aggregator and a JAX worker to a
    port aggregator, both as host ``w``: the two ``/fleet`` pages of the
    pushed metrics are equal, and each aggregator's merged counters are
    the pushing registry's."""
    pt.set_flags({"enable_metrics": True, "metrics_port": -1})
    _fill(obs)
    _fill(jax_obs)
    jsrv = jax_server.ObservabilityServer(0)
    psrv = obs_server.start(0)
    prep = fleet.FleetReporter(f"127.0.0.1:{jsrv.port}", host_id="w",
                               interval_s=60)
    jrep = jax_fleet.FleetReporter(f"127.0.0.1:{psrv.port}", host_id="w",
                                   interval_s=60)
    try:
        assert prep.push_once() and jrep.push_once()
        code_j, page_j = _get(jsrv.port, "/fleet?name=t_xfed_")
        code_p, page_p = _get(psrv.port, "/fleet?name=t_xfed_")
        assert code_j == code_p == 200
        assert page_p == page_j
        assert 't_xfed_total{kind="a"} 3' in page_p
        assert 't_xfed_depth{host="w"} 4.5' in page_p
        for port in (jsrv.port, psrv.port):
            view = json.loads(_get(port, "/fleet?format=json")[1])
            assert list(view["hosts"]) == ["w"]
            assert "merge_error" not in view
    finally:
        prep.stop()
        jrep.stop()
        jsrv.stop()
        jax_fleet.aggregator().reset()
