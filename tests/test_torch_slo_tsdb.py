"""PyTorch port: the tsdb rings and the SLO engine against the JAX package.

The JAX suite's tsdb and SLO tests run against the port case for case
(injected monotonic stamps, ``slo_window_scale`` shrinking the windows),
then the same seeded counter and histogram sequences go into both
packages' registries and rings under one fake clock: windowed
``increase``/``rate``/``quantile_over_window`` and every SLO state, burn
rate and error budget must be equal. No test bounds a wall time.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import math
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import observability as jax_obs  # noqa: E402
from paddle_tpu.observability import metrics as jax_metrics  # noqa: E402
from paddle_tpu.observability import slo as jax_slo  # noqa: E402
from paddle_tpu.observability import tsdb as jax_tsdb  # noqa: E402

import paddle_tpu_torch as ptt  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.observability import slo, tsdb  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated():
    """Both packages' registries, rings and SLO engines empty before and
    after; metrics on in both; every flag set here restored."""
    jax_on = jax_metrics.enabled()
    pt.set_flags({"enable_metrics": True, "metrics_port": -1})
    ptt.set_flags({"enable_metrics": True})
    jax_obs.reset_all()
    obs.reset_all()
    try:
        yield
    finally:
        ptt.set_flags({"enable_metrics": False, "tsdb_ring": 512,
                       "slo_window_scale": 1.0, "tsdb_interval_s": 1.0})
        pt.set_flags({"enable_metrics": False, "metrics_port": 0,
                      "tsdb_ring": 512, "slo_window_scale": 1.0})
        jax_obs.reset_all()
        obs.reset_all()
        jax_metrics.set_enabled(jax_on)


# -- the JAX suite's cases ---------------------------------------------------

def test_tsdb_windowed_reads():
    """Windowed increase/rate/quantile against injected monotonic
    stamps: baseline at the window's left edge, counter resets clamp,
    histogram deltas interpolate, resize keeps the newest samples."""
    ring = tsdb.ring()
    c = obs.counter("selftest_tsdb_reqs_total", "h")
    h = obs.histogram("selftest_tsdb_lat_ms", "h",
                      buckets=(10.0, 100.0, 1000.0))
    tsdb.watch("selftest_tsdb_reqs_total", "selftest_tsdb_lat_ms")
    for _ in range(4):
        h.observe(5.0)
    assert ring.sample_once(now=100.0) == 2
    c.inc(5)
    assert ring.sample_once(now=101.0) == 2
    c.inc(2)
    for _ in range(4):
        h.observe(50.0)
    ring.sample_once(now=102.0)
    assert ring.increase("selftest_tsdb_reqs_total", 1.5, now=102.0) == 7
    assert ring.increase("selftest_tsdb_reqs_total", 0.5, now=102.0) == 2
    assert ring.rate("selftest_tsdb_reqs_total", 0.5, now=102.0) \
        == pytest.approx(4.0)
    assert ring.increase("selftest_tsdb_nope_total", 9.0) == 0.0
    d = ring.hist_increase("selftest_tsdb_lat_ms", 0.5, now=102.0)
    assert d["counts"] == (0, 4, 4) and d["count"] == 4
    assert ring.quantile_over_window(
        "selftest_tsdb_lat_ms", 0.5, 0.5, now=102.0) == pytest.approx(55.0)
    ring.sample_once(now=102.5)
    assert np.isnan(ring.quantile_over_window(
        "selftest_tsdb_lat_ms", 0.5, 0.4, now=102.5))
    assert ring.value("selftest_tsdb_reqs_total") == 7.0
    # a registry reset mid-flight: the newer, smaller sample IS the
    # increase
    obs.registry().reset()
    obs.counter("selftest_tsdb_reqs_total", "h").inc(3)
    ring.sample_once(now=103.0)
    assert ring.increase("selftest_tsdb_reqs_total", 1.6, now=103.0) == 3
    # FLAGS_tsdb_ring's on_change hook rebuilds the deques, newest kept
    ptt.set_flags({"tsdb_ring": 8})
    assert ring.capacity == 8
    for i in range(20):
        ring.sample_once(now=104.0 + i)
    stats = ring.stats()
    assert stats["capacity"] == 8
    assert stats["samples"]["selftest_tsdb_reqs_total"] == 8
    assert obs.gauge("tsdb_ring_entries").value() == float(
        sum(stats["samples"].values()))
    assert obs.gauge("tsdb_ring_series").value() == 2.0
    ring.reset()
    assert ring.stats()["series"] == 0


def test_slo_state_machine_with_injected_clock():
    """inactive -> pending -> firing -> resolved -> inactive through
    evaluate(now=) on hand-stamped samples, transitions counted,
    flight-recorded and published."""
    eng = slo.engine()
    ring = tsdb.ring()
    eng.register(slo.SLOSpec(
        "selftest_burn", "ratio", target=0.99,
        good="selftest_slo_good_total", total="selftest_slo_req_total"))
    good = obs.counter("selftest_slo_good_total", "h")
    req = obs.counter("selftest_slo_req_total", "h")

    def state(now):
        return {a["slo"]: a for a in eng.evaluate(now=now)}["selftest_burn"]

    ptt.set_flags({"slo_window_scale": 0.001})
    ring.sample_once(now=1000.0)
    assert state(1000.0)["state"] == "inactive"
    good.inc(400)
    req.inc(400)
    ring.sample_once(now=1001.0)
    req.inc(10)
    ring.sample_once(now=1004.5)
    a = state(1004.5)
    assert a["state"] == "pending"
    assert not any(w["over"] for w in a["windows"].values())
    req.inc(10)
    ring.sample_once(now=1005.0)
    a = state(1005.0)
    assert a["state"] == "firing" and a["trigger_pair"] == "fast"
    assert a["windows"]["fast"]["short"]["burn_rate"] > 14.4
    assert a["windows"]["fast"]["severity"] == "page"
    assert a["budget_remaining"] == pytest.approx(
        1.0 - 20.0 / ((1.0 - 0.99) * 420.0))
    ring.sample_once(now=1050.0)
    assert state(1050.0)["state"] == "resolved"
    assert state(1051.0)["state"] == "inactive"
    tos = [t["to"] for t in
           eng.alerts_view(now=1051.5)["alerts"][0]["history"]]
    assert tos == ["pending", "firing", "resolved", "inactive"]
    assert obs.counter("slo_alert_transitions_total").value(
        slo="selftest_burn", to="firing") == 1
    fired = [e["to_state"] for e in obs.flight_recorder().events()
             if e["kind"] == "slo_alert" and e["slo"] == "selftest_burn"]
    assert fired == ["pending", "firing", "resolved", "inactive"]
    assert obs.gauge("slo_alert_state").value(slo="selftest_burn") == 0.0


@pytest.mark.parametrize("kwargs, match", [
    (dict(kind="nope", target=0.9), "unknown SLO kind"),
    (dict(kind="ratio", target=0.9, good="a_total"), "needs good= and"),
    (dict(kind="latency", target=0.9, hist="h_ms"), "needs hist= and"),
    (dict(kind="absence", target=1.0), "needs counter="),
    (dict(kind="ratio", target=1.5, good="a", total="b"), "target must"),
])
def test_slo_spec_validation_matches_jax(kwargs, match):
    for mod in (slo, jax_slo):
        with pytest.raises(ValueError, match=match):
            mod.SLOSpec("x", **kwargs)


def test_default_pack_is_the_jax_pack():
    slo.ensure_default_pack()
    eng = jax_slo.SloEngine(jax_tsdb.TsdbRing())
    eng.ensure_default_pack()
    assert [s.to_dict() for s in slo.engine().specs()] \
        == [s.to_dict() for s in eng.specs()]
    assert slo.WINDOW_PAIRS == jax_slo.WINDOW_PAIRS
    assert slo.STATE_ORDER == jax_slo.STATE_ORDER
    # the pack's metrics joined the sampled set
    assert set(tsdb.ring().watched()) >= {
        "serving_stream_requests_total", "serving_ttft_ms",
        "goodput_seconds_total", "nonfinite_steps_total"}


def test_sampler_thread_samples_evaluates_and_stops():
    ptt.set_flags({"tsdb_interval_s": 0.01})
    slo.ensure_default_pack()
    obs.counter("serving_stream_requests_total", "h").inc(3)
    tsdb.start()
    try:
        names = [t.name for t in threading.enumerate()]
        assert "pt-tsdb-sampler" in names
        ev = threading.Event()
        for _ in range(500):
            if tsdb.ring().stats()["samples"].get(
                    "serving_stream_requests_total", 0) >= 2:
                break
            ev.wait(0.01)
        assert tsdb.ring().value("serving_stream_requests_total") == 3.0
        # each tick evaluates the SLOs: the state gauges exist
        assert obs.gauge("slo_alert_state").value(
            slo="serving_availability") == 0.0
    finally:
        tsdb.stop()
    assert "pt-tsdb-sampler" not in [t.name for t in threading.enumerate()]


# -- parity: the same sequence into both packages ------------------------------

def _drive(reg_mod, ring, seed: int, stamps) -> None:
    """A seeded sequence of counter increments and histogram observations,
    a sample stamped at each of ``stamps`` (a registry reset halfway)."""
    rng = np.random.default_rng(seed)
    c = reg_mod.counter("t_par_reqs_total", "h")
    b = reg_mod.counter("t_par_bad_total", "h")
    h = reg_mod.histogram("t_par_lat_ms", "h",
                          buckets=(1.0, 10.0, 100.0, 1000.0))
    for i, t in enumerate(stamps):
        if i == len(stamps) // 2:
            reg_mod.registry().reset()
            c = reg_mod.counter("t_par_reqs_total", "h")
            b = reg_mod.counter("t_par_bad_total", "h")
            h = reg_mod.histogram("t_par_lat_ms", "h",
                                  buckets=(1.0, 10.0, 100.0, 1000.0))
        n = int(rng.integers(0, 20))
        c.inc(n)
        b.inc(int(rng.integers(0, n + 1)) if rng.random() < 0.3 else 0)
        for v in rng.exponential(40.0, int(rng.integers(0, 6))):
            h.observe(float(np.round(v, 3)))
        ring.sample_once(now=t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_reads_equal_jax(seed):
    names = ("t_par_reqs_total", "t_par_bad_total", "t_par_lat_ms")
    stamps = [500.0 + 0.5 * i for i in range(40)]
    rings = []
    for mod, tmod in ((jax_obs, jax_tsdb), (obs, tsdb)):
        ring = tmod.TsdbRing(capacity=64)
        ring.watch(*names)
        _drive(mod, ring, seed, stamps)
        rings.append(ring)
    now = stamps[-1]
    for w in (0.4, 1.0, 3.3, 7.5, 30.0):
        for name in names[:2]:
            assert rings[1].increase(name, w, now=now) \
                == rings[0].increase(name, w, now=now)
            assert rings[1].rate(name, w, now=now) \
                == rings[0].rate(name, w, now=now)
        assert rings[1].hist_increase(names[2], w, now=now) \
            == rings[0].hist_increase(names[2], w, now=now)
        for q in (0.5, 0.9, 0.99):
            a = rings[0].quantile_over_window(names[2], q, w, now=now)
            b = rings[1].quantile_over_window(names[2], q, w, now=now)
            assert (math.isnan(a) and math.isnan(b)) or a == b
    assert rings[1].stats() == rings[0].stats()


@pytest.mark.parametrize("seed", [0, 3])
def test_slo_states_burn_rates_and_budgets_equal_jax(seed):
    """Ratio, latency and absence specs judged on the same counter
    sequence under one fake clock: every evaluation's states, windows
    (burn rates, bad/total) and budgets are equal in both packages."""
    def specs(mod):
        return [mod.SLOSpec("t_avail", "ratio", target=0.95,
                            good="t_par_reqs_total - t_par_bad_total",
                            total="t_par_reqs_total"),
                mod.SLOSpec("t_lat", "latency", target=0.9,
                            hist="t_par_lat_ms", threshold_ms=60.0),
                mod.SLOSpec("t_never", "absence", target=1.0,
                            counter="t_par_bad_total")]

    pt.set_flags({"slo_window_scale": 0.002})
    ptt.set_flags({"slo_window_scale": 0.002})
    stamps = [2000.0 + 0.25 * i for i in range(60)]
    views = []
    for mod, tmod, smod in ((jax_obs, jax_tsdb, jax_slo),
                            (obs, tsdb, slo)):
        ring = tmod.TsdbRing(capacity=256)
        eng = smod.SloEngine(ring)
        for s in specs(smod):
            eng.register(s)
        rng = np.random.default_rng(seed)
        c = mod.counter("t_par_reqs_total", "h")
        b = mod.counter("t_par_bad_total", "h")
        h = mod.histogram("t_par_lat_ms", "h",
                          buckets=(1.0, 10.0, 100.0, 1000.0))
        seen = []
        for i, t in enumerate(stamps):
            burst = 20 <= i < 30
            n = int(rng.integers(5, 20))
            c.inc(n)
            b.inc(int(rng.integers(0, n // 2 + 1)) if burst else 0)
            for v in rng.exponential(80.0 if burst else 20.0,
                                     int(rng.integers(1, 6))):
                h.observe(float(np.round(v, 3)))
            ring.sample_once(now=t)
            for a in eng.evaluate(now=t):
                seen.append({k: a[k] for k in (
                    "slo", "state", "windows", "budget_remaining",
                    "trigger_pair", "transitions")})
        views.append((seen, eng.slo_view(now=stamps[-1])["slos"]))
    assert views[1] == views[0]
    states = {s["state"] for s in views[1][0]}
    assert "firing" in states  # the burst trips an alert
