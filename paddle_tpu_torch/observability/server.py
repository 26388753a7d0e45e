"""Live observability plane: stdlib HTTP exporter for a running process.

Counterpart of ``paddle_tpu.observability.server``: the same endpoints,
query parameters, JSON shapes, metric names and port semantics, so a
dashboard, an alert rule or a ``tools/*_report.py`` written for the JAX
package reads the port unchanged. Pure stdlib (``http.server`` on a
daemon thread), started automatically by ``inference.Server`` when
metrics are enabled and ``FLAGS_metrics_port`` >= 0, or explicitly via
:func:`start`. Where the JAX exporter reads JAX, this one reads torch:
``/healthz`` names the CUDA devices (``torch.cuda.device_count`` and
``get_device_name``; the CPU on a machine without a card) and ``/varz``
lists the torch and CUDA versions.

Every handler reads host-side state only (the registry, the rings, the
caching allocator's statistics, cached device properties): no device
synchronisation and no allocation on the card, so a scrape can never
invalidate a CUDA-graph capture running on another thread.

Endpoints:

- ``/metrics``  — Prometheus text exposition of the metrics registry,
  plus the native stat registry (``pt_mon_dump``) bridged as
  ``pt_native_stat{name=...}`` series; ``?name=prefix[,prefix]``
  keeps only matching metric names (still valid exposition text).
- ``/alerts``   — SLO alert states (observability/slo.py): per-spec
  state machine, observed burn rates per window, exact error-budget
  remaining, transition history, tsdb ring stats.
- ``/slo``      — the SLO specs themselves + lifetime compliance.
- ``/healthz``  — device liveness (the CUDA devices) + training
  heartbeat staleness: a wedged training loop reads unhealthy (HTTP 503)
  once the last-step heartbeat is older than
  ``FLAGS_health_heartbeat_timeout_s``.
- ``/varz``     — full JSON snapshot: metrics, capture records,
  program cards (xprof), per-device memory, native stats.
- ``/trace?ms=N`` — on-demand chrome-trace capture window: returns the
  host spans recorded during the next N milliseconds as a
  ``traceEvents`` JSON (Perfetto-loadable).
- ``/goodput``  — the wall-time ledger (per-bucket seconds/ratios and
  the goodput headline, observability/goodput.py).
- ``/flight``   — the crash flight recorder's live event ring
  (observability/flight.py).
- ``/requests?n=`` — the last N per-request serving span records
  (observability/reqtrace.py: trace id + the five lifecycle
  timestamps + derived latency spans).
- ``/llm/seqs?n=&trace_id=`` — per-sequence engine lifecycle
  timelines (observability/seqtrace.py): live + last N finished, or
  every timeline carrying a wire ``trace_id`` (the /requests join).
- ``/llm/steps?n=`` — engine step records (observability/stepprof.py):
  the last N sealed records plus the LIVE in-flight step per engine
  (begin stamps + current phase — a wedged step is visible here
  while it hangs).
- ``/stacks?n=&format=`` — instant all-thread stack dump + the
  sampling profiler's state (observability/stacks.py). **Not gated on
  FLAGS_enable_metrics**: wedge forensics must answer while a process
  hangs, flags notwithstanding. ``format=collapsed`` returns the
  folded-stack profile as text, ``format=flame`` the Chrome
  ``traceEvents`` flame view (Perfetto-loadable).
- ``/fleet`` (+ ``/fleet/goodput``, ``/fleet/health``,
  ``/fleet/alerts``, and the worker-facing ``POST /fleet/push``) —
  the cross-host federation plane (observability/fleet.py): any
  process's exporter doubles as the fleet aggregator; workers push
  snapshots here and the merged view (counters summed, gauges
  ``{host=}``-labeled, histograms merged bucket-wise) is served back.
  ``/fleet`` honours the same ``?name=`` prefix filter as
  ``/metrics``; ``/fleet/health`` answers 503 when any host's push is
  stale; ``/fleet/alerts`` merges SLO alert states worst-state-wins
  with per-host attribution.

Port selection (``FLAGS_metrics_port``): a positive value binds that
port; **0 (the default) binds an ephemeral port** — the chosen port is
published through the ``observability_server_port`` gauge and one log
line, so parallel test runs and co-scheduled jobs never collide; a
negative value disables the exporter. ``start()`` is idempotent: once
one server is bound, later calls from fit/Server share it.

The server binds all interfaces (a scrape endpoint); everything it
serves is read-only telemetry.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import torch

from ..flags import GLOBAL_FLAGS
from . import fleet as _fleet
from . import flight as _flight
from . import goodput as _goodput
from . import metrics as _metrics
from . import recompile as _recompile
from . import reqtrace as _reqtrace
from . import seqtrace as _seqtrace
from . import slo as _slo
from . import stacks as _stacks
from . import stepprof as _stepprof
from . import tracer as _tracer
from . import tsdb as _tsdb
from . import xprof as _xprof

_log = logging.getLogger("paddle_tpu_torch.observability")

__all__ = ["ObservabilityServer", "start", "stop", "get",
           "maybe_start", "HEARTBEAT_GAUGE"]

# Gauge name a training loop sets each step; /healthz judges staleness
# by it.
HEARTBEAT_GAUGE = "train_heartbeat_timestamp_seconds"

_TRACE_WINDOW_MAX_MS = 60_000

# the port's own serving modules, looked up (never imported) by /healthz
# and /router
_PKG = __name__.split(".")[0]


def _native_stats() -> Dict[str, int]:
    """Native stat registry snapshot — only when the library is already
    loaded (never trigger a g++ build from a scrape)."""
    from . import native_stats
    return native_stats()


def _device_health() -> Dict[str, Any]:
    """The process's devices: every CUDA device with its name, or the
    CPU on a machine without a card. Host-side reads only (the device
    count and cached properties), legal during another thread's
    capture."""
    try:
        if not torch.cuda.is_available():
            return {"ok": True, "device_count": 1, "devices": ["cpu"]}
        n = torch.cuda.device_count()
        return {"ok": n > 0, "device_count": n,
                "devices": [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                            for i in range(n)]}
    except Exception as e:  # noqa: BLE001
        return {"ok": False, "device_count": 0,
                "error": f"{type(e).__name__}: {e}"}


def _heartbeat_age_s() -> Optional[float]:
    g = _metrics.registry().get(HEARTBEAT_GAUGE)
    if g is None:
        return None
    v = g.value()
    if v is None:
        return None
    try:
        # ptlint: disable=clock-hygiene -- the heartbeat gauge is an exported wall stamp by name (train_heartbeat_timestamp_seconds); its age is necessarily wall-minus-wall
        return max(0.0, time.time() - float(v))
    except (TypeError, ValueError):
        return None


def _healthz() -> Dict[str, Any]:
    out = _device_health()
    age = _heartbeat_age_s()
    out["heartbeat_age_s"] = age
    timeout = float(GLOBAL_FLAGS.get("health_heartbeat_timeout_s"))
    out["heartbeat_timeout_s"] = timeout
    if age is not None and timeout > 0 and age > timeout:
        out["ok"] = False
        out["wedged"] = True
    serving = _serving_health()
    if serving is not None:
        out["serving"] = serving
        if not serving.get("ok", True):
            out["ok"] = False
    out["status"] = "ok" if out["ok"] else "unhealthy"
    return out


def _serving_health() -> Optional[Dict[str, Any]]:
    """LLM-serving section for /healthz: engine stall-watchdog and
    KV-audit state. None when the serving subsystem was never imported
    (checking must not drag serving_llm into a trainer) or holds
    no engines."""
    mod = sys.modules.get(_PKG + ".serving_llm.engine")
    if mod is None:
        return None
    try:
        snap = mod.health_snapshot()
    except Exception:  # noqa: BLE001 — health must never 500
        return None
    return snap if snap.get("engines") else None


def _router_snapshots() -> list:
    """Live front-door router snapshots for GET /router. Lazy like
    :func:`_serving_health`: the endpoint answers [] (not an import)
    when serving_llm.router was never loaded in this process."""
    mod = sys.modules.get(_PKG + ".serving_llm.router")
    if mod is None:
        return []
    try:
        return mod.snapshot_all()
    except Exception:  # noqa: BLE001 — telemetry must never 500
        return []


def _flags_snapshot() -> Dict[str, Any]:
    return dict(GLOBAL_FLAGS.snapshot())


def _versions() -> Dict[str, Any]:
    return {"python": sys.version.split()[0],
            "torch": torch.__version__,
            "cuda": torch.version.cuda}


def _varz() -> Dict[str, Any]:
    from . import device_memory_stats
    return {
        "unix_time": time.time(),
        "versions": _versions(),
        "flags": _flags_snapshot(),
        "metrics": _metrics.registry().snapshot(),
        "recompile": _recompile.tracker().snapshot(),
        "programs": _xprof.cards().snapshot(),
        "device_memory": device_memory_stats(include_unavailable=True,
                                             full=True),
        "native_stats": _native_stats(),
        "health": _healthz(),
    }


def metrics_text(name_prefixes=None) -> str:
    """Prometheus page body: registry exposition + bridged native
    stats (shared by the HTTP handler and export_all's metrics.prom).
    ``name_prefixes`` (the ``/metrics?name=`` filter) keeps only
    metrics whose name starts with any given prefix — the bridged
    ``pt_native_stat`` block filters by its own name like any other."""
    text = _metrics.registry().prometheus_text(name_prefixes)
    if name_prefixes is not None:
        prefixes = tuple(p for p in name_prefixes if p)
        if not prefixes or not "pt_native_stat".startswith(prefixes):
            return text
    native = _native_stats()
    if native:
        lines = ["# HELP pt_native_stat native stat registry "
                 "(csrc/monitor.cc) bridged via pt_mon_dump",
                 "# TYPE pt_native_stat counter"]
        for k in sorted(native):
            lines.append(f'pt_native_stat{{name="{k}"}} {native[k]}')
        text += "\n".join(lines) + "\n"
    return text


def _trace_window(ms: int) -> Dict[str, Any]:
    """Record host spans for ``ms`` milliseconds and return them as a
    chrome trace. Spans only appear while FLAGS_enable_metrics is on
    (the endpoint reports what it captured either way)."""
    ms = max(1, min(int(ms), _TRACE_WINDOW_MAX_MS))
    tr = _tracer.tracer()
    before = len(tr.events())
    time.sleep(ms / 1e3)
    window = tr.events()[before:]
    full = tr.chrome_trace()
    meta = [e for e in full["traceEvents"] if e.get("ph") == "M"]
    return {"traceEvents": meta + window,
            "displayTimeUnit": "ms",
            "metadata": {"window_ms": ms, "events_in_window": len(window),
                         "metrics_enabled": _metrics.enabled()}}


def _name_prefixes(q: Dict[str, Any]) -> Optional[Tuple[str, ...]]:
    """The ``?name=`` filter: comma-separated metric-name prefixes
    (repeatable); None when the parameter is absent (no filter)."""
    if "name" not in q:
        return None
    out: Tuple[str, ...] = ()
    for v in q["name"]:
        out += tuple(p.strip() for p in v.split(",") if p.strip())
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle_tpu_torch_obs/1"

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: Any) -> None:
        body = json.dumps(obj, indent=1, sort_keys=True,
                          default=str).encode()
        self._send(code, body, "application/json")

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        try:
            url = urlparse(self.path)
            if url.path == "/metrics":
                q = parse_qs(url.query)
                prefixes = _name_prefixes(q)
                self._send(200, metrics_text(prefixes).encode(),
                           "text/plain; version=0.0.4")
            elif url.path == "/healthz":
                h = _healthz()
                self._send_json(200 if h["ok"] else 503, h)
            elif url.path == "/varz":
                self._send_json(200, _varz())
            elif url.path == "/trace":
                q = parse_qs(url.query)
                ms = int(q.get("ms", ["500"])[0])
                self._send_json(200, _trace_window(ms))
            elif url.path == "/goodput":
                self._send_json(200, _goodput.ledger().snapshot())
            elif url.path == "/alerts":
                _slo.ensure_default_pack()
                view = _slo.engine().alerts_view()
                view["tsdb"] = _tsdb.ring().stats()
                self._send_json(200, view)
            elif url.path == "/slo":
                _slo.ensure_default_pack()
                self._send_json(200, _slo.engine().slo_view())
            elif url.path == "/flight":
                rec = _flight.recorder()
                self._send_json(200, {"capacity": rec.capacity,
                                      "events": rec.events()})
            elif url.path == "/requests":
                q = parse_qs(url.query)
                try:
                    n = int(q.get("n", ["0"])[0]) or None
                except ValueError:
                    n = None
                r = _reqtrace.ring()
                self._send_json(200, {"capacity": r.capacity,
                                      "requests": r.recent(n)})
            elif url.path == "/llm/seqs":
                q = parse_qs(url.query)
                try:
                    n = int(q.get("n", ["0"])[0]) or None
                except ValueError:
                    n = None
                sr = _seqtrace.ring()
                tid = q.get("trace_id", [None])[0]
                if tid is not None:
                    try:
                        timelines = sr.find(int(tid))
                    except ValueError:
                        timelines = []
                    self._send_json(200, {"trace_id": tid,
                                          "timelines": timelines})
                else:
                    self._send_json(200, {"capacity": sr.capacity,
                                          "live": sr.live(),
                                          "finished": sr.recent(n)})
            elif url.path == "/llm/steps":
                q = parse_qs(url.query)
                try:
                    n = int(q.get("n", ["0"])[0]) or None
                except ValueError:
                    n = None
                pr = _stepprof.ring()
                self._send_json(200, {"capacity": pr.capacity,
                                      "live": pr.live(),
                                      "steps": pr.recent(n)})
            elif url.path == "/stacks":
                q = parse_qs(url.query)
                fmt = q.get("format", [""])[0]
                if fmt == "collapsed":
                    self._send(200, _stacks.collapsed_text().encode(),
                               "text/plain")
                elif fmt == "flame":
                    self._send_json(200, _stacks.flame_trace())
                else:
                    try:
                        n = int(q.get("n", ["0"])[0]) \
                            or _stacks.DEFAULT_TOP_N
                    except ValueError:
                        n = _stacks.DEFAULT_TOP_N
                    self._send_json(200, _stacks.stacks_view(n))
            elif url.path == "/fleet/stacks":
                self._send_json(200, _fleet.fleet_stacks())
            elif url.path == "/fleet":
                q = parse_qs(url.query)
                if q.get("format", [""])[0] == "json":
                    self._send_json(200, _fleet.fleet_view())
                else:
                    prefixes = _name_prefixes(q)
                    self._send(
                        200,
                        _fleet.fleet_prometheus_text(prefixes).encode(),
                        "text/plain; version=0.0.4")
            elif url.path == "/fleet/goodput":
                self._send_json(200, _fleet.fleet_goodput())
            elif url.path == "/fleet/health":
                ok, payload = _fleet.fleet_health()
                self._send_json(200 if ok else 503, payload)
            elif url.path == "/fleet/alerts":
                self._send_json(200, _fleet.fleet_alerts())
            elif url.path == "/router":
                self._send_json(200, {"routers": _router_snapshots()})
            elif url.path == "/":
                self._send(200,
                           b"paddle_tpu_torch observability: "
                           b"/metrics?name=P "
                           b"/healthz /varz /trace?ms=N /goodput "
                           b"/alerts /slo /flight "
                           b"/requests?n=N /llm/seqs?n=N&trace_id=T "
                           b"/llm/steps?n=N /stacks?format=F "
                           b"/fleet?name=P /fleet/goodput "
                           b"/fleet/health /fleet/alerts "
                           b"/fleet/stacks /router\n",
                           "text/plain")
            else:
                self._send(404, b"not found\n", "text/plain")
        # ptlint: disable=silent-failure -- client hung up mid-response; nothing to answer and nothing to fix
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — keep the exporter alive
            try:
                self._send_json(500,
                                {"error": f"{type(e).__name__}: {e}"})
            # ptlint: disable=silent-failure -- the 500 itself failed (socket dead): the exporter thread must survive any request
            except Exception:
                pass

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        try:
            url = urlparse(self.path)
            if url.path != "/fleet/push":
                self._send(404, b"not found\n", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = 0
            if n <= 0 or n > 64 << 20:  # bound a bad/abusive length
                self._send_json(400, {"error": "bad Content-Length"})
                return
            body = self.rfile.read(n)
            try:
                snapshot = json.loads(body)
                # peer IP gives the stacks fan-out a dialable address
                # even when PT_FLEET_HOST is a hostname:rank label
                host = _fleet.aggregator().ingest(
                    snapshot, peer=self.client_address[0])
            except (ValueError, TypeError) as e:
                self._send_json(400, {"error": f"bad fleet push: {e}"})
                return
            self._send_json(200, {"ok": True, "host": host})
        # ptlint: disable=silent-failure -- client hung up mid-response; nothing to answer and nothing to fix
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — keep the exporter alive
            try:
                self._send_json(500,
                                {"error": f"{type(e).__name__}: {e}"})
            # ptlint: disable=silent-failure -- the 500 itself failed (socket dead): the exporter thread must survive any request
            except Exception:
                pass


class ObservabilityServer:
    """Daemon-threaded HTTP exporter; ``port`` <= 0 binds ephemeral."""

    def __init__(self, port: int = 0) -> None:
        self._httpd = ThreadingHTTPServer(("", max(0, int(port))),
                                          _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="pt-observability-http")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_lock = threading.Lock()
_server: Optional[ObservabilityServer] = None  # guarded-by: _lock


def start(port: int = 0) -> ObservabilityServer:
    """Start (or return) the process-wide exporter; ``port`` 0 binds
    an ephemeral port. Idempotent: a second call returns the running
    server regardless of port (a differing explicit request is
    logged, not honoured — one process, one exporter)."""
    global _server
    with _lock:
        if _server is None:
            _server = ObservabilityServer(port)
            _metrics.gauge(
                "observability_server_port",
                "TCP port of the live observability HTTP exporter",
                always=True).set(float(_server.port))
            _log.info("observability exporter serving /metrics /healthz "
                      "/varz /trace /goodput /flight /requests "
                      "/llm/seqs /llm/steps /fleet on :%d",
                      _server.port)
        elif port > 0 and port != _server.port:
            _log.info("observability exporter already bound on :%d; "
                      "ignoring request for :%d", _server.port, port)
        return _server


def get() -> Optional[ObservabilityServer]:
    return _server


def stop() -> None:
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None


def maybe_start() -> Optional[ObservabilityServer]:
    """Flag-driven start, called from inference.Server (and a training
    loop): metrics enabled and FLAGS_metrics_port >= 0 (0 = ephemeral
    bind, negative = exporter off). Also the fleet hook: when the
    launcher provided PT_FLEET_AGGREGATOR, the push reporter starts
    alongside the exporter (fleet.py). The fleet, SLO/tsdb and hang
    doctor starts are logged and swallowed: telemetry must not break
    the caller."""
    if not _metrics.enabled():
        return _server
    port = int(GLOBAL_FLAGS.get("metrics_port"))
    if port < 0:
        return _server
    srv = start(port)
    try:
        _fleet.maybe_start_reporter()
    except Exception:  # noqa: BLE001 — federation must not break a run
        _log.exception("fleet reporter failed to start")
    try:
        # the SLO/tsdb judgment layer rides the exporter's lifecycle:
        # install the default pack (its metrics join the watch set)
        # and start the sampler so burn-rate windows begin filling
        _slo.ensure_default_pack()
        _tsdb.start()
    except Exception:  # noqa: BLE001 — judgment layer must not break a run
        _log.exception("tsdb sampler failed to start")
    try:
        # hang-doctor plane: stack sampler (flag-gated), live wedge
        # monitor, and the SIGUSR2 dump handler ride the same lifecycle
        _stacks.maybe_start()
    except Exception:  # noqa: BLE001 — forensics must not break a run
        _log.exception("hang doctor failed to start")
    return srv


# ----------------------------------------------------------------- CLI

def self_test() -> int:
    """No-card check: boot on an ephemeral port, populate one of every
    endpoint's inputs, GET them all, assert, exit 0. Run with ``python
    -m paddle_tpu_torch.observability.server --self-test``."""
    import urllib.request

    _metrics.set_enabled(True)
    srv = ObservabilityServer(0)
    try:
        _metrics.counter("selftest_http_total", always=True).inc(3)
        _metrics.gauge(HEARTBEAT_GAUGE, always=True).set(time.time())
        # the port gauge normally comes from start(); /fleet/stacks
        # dials back through the pushed port, so set it here too
        _metrics.gauge("observability_server_port",
                       "TCP port of the live observability HTTP "
                       "exporter", always=True).set(float(srv.port))
        with _tracer.tracer().span("selftest/http", force=True):
            time.sleep(0.001)

        def fetch(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}",
                    timeout=10) as r:
                return r.status, r.read().decode()

        code, text = fetch("/metrics")
        assert code == 200 and "selftest_http_total 3" in text, text
        code, text = fetch("/healthz")
        assert code == 200 and json.loads(text)["status"] == "ok", text
        code, text = fetch("/varz")
        varz = json.loads(text)
        assert code == 200 and "selftest_http_total" in varz["metrics"]
        assert "programs" in varz and "device_memory" in varz
        code, text = fetch("/trace?ms=20")
        trace = json.loads(text)
        assert code == 200 and "traceEvents" in trace, text
        _flight.record("selftest_event", step=1)
        code, text = fetch("/flight")
        fl = json.loads(text)
        assert code == 200 and any(
            e["kind"] == "selftest_event" for e in fl["events"]), text
        code, text = fetch("/goodput")
        gp = json.loads(text)
        assert code == 200 and "goodput_ratio" in gp \
            and set(gp["buckets"]) >= set(_goodput.BUCKETS), text
        # ?name= prefix filter keeps the exposition parseable
        code, text = fetch("/metrics?name=selftest_")
        assert code == 200 and "selftest_http_total 3" in text, text
        assert "observability_server_port" not in text, text
        # SLO plane: default pack installed on first read, every spec
        # starts inactive with a full budget
        code, text = fetch("/alerts")
        al = json.loads(text)
        assert code == 200 and al["worst_state"] == "inactive", text
        names = {a["slo"] for a in al["alerts"]}
        assert {"serving_availability", "serving_ttft_p99",
                "kv_audit_clean"} <= names, names
        code, text = fetch("/slo")
        sl = json.loads(text)
        assert code == 200 and len(sl["slos"]) == len(names), text
        assert all(s["budget_remaining"] == 1.0 or s["lifetime"]["total"]
                   for s in sl["slos"]), text
        _reqtrace.record({"trace_id": 7, "ingress_unix": time.time(),
                          "reply_unix": time.time()})
        code, text = fetch("/requests?n=5")
        rq = json.loads(text)
        assert code == 200 and any(
            r.get("trace_id") == 7 for r in rq["requests"]), text
        # serving flight deck: one finished timeline, one live one,
        # one sealed step record + one live in-flight step
        _seqtrace.begin(11, trace_id=7)
        _seqtrace.event(11, "token", index=0)
        _seqtrace.finish(11, "finished", reason="eos", tokens=1)
        _seqtrace.begin(12, trace_id=9)
        _stepprof.ring().step_begin(1, step=4, begin_unix=time.time())
        _stepprof.ring().record(1, {"step": 4, "engine": 1,
                                    "phase_ms": {"decode": 1.5}})
        _stepprof.ring().step_begin(2, step=5, begin_unix=time.time())
        _stepprof.ring().set_phase(2, "prefill")
        code, text = fetch("/llm/seqs?n=5")
        sq = json.loads(text)
        assert code == 200 and any(
            t["seq_id"] == 11 and t["outcome"] == "finished"
            for t in sq["finished"]), text
        assert any(t["seq_id"] == 12 for t in sq["live"]), text
        code, text = fetch("/llm/seqs?trace_id=7")
        sq = json.loads(text)
        assert code == 200 and len(sq["timelines"]) == 1 \
            and sq["timelines"][0]["seq_id"] == 11, text
        code, text = fetch("/llm/steps?n=5")
        st = json.loads(text)
        assert code == 200 and any(
            r["step"] == 4 for r in st["steps"]), text
        assert any(d["step"] == 5 and d["phase"] == "prefill"
                   and "age_s" in d for d in st["live"]), text
        # front-door router plane: lazy like /healthz's serving
        # section — an empty roster (router module never imported)
        # still answers with the JSON shape
        code, text = fetch("/router")
        rt = json.loads(text)
        assert code == 200 and isinstance(rt["routers"], list), text
        # hang-doctor plane: the live dump always answers, the sampled
        # profile appears once the sampler ticks, and both export
        # shapes parse
        from ..flags import set_flags as _set_flags
        _set_flags({"stack_sample_hz": 200.0})
        try:
            time.sleep(0.05)
            code, text = fetch("/stacks")
            sv = json.loads(text)
            assert code == 200 and any(
                t["name"] == "MainThread" for t in sv["threads"]), text
            assert sv["sampler"]["running"], text
            code, text = fetch("/stacks?format=collapsed")
            assert code == 200 and "pt-observability-http" in text, text
            code, text = fetch("/stacks?format=flame")
            fl2 = json.loads(text)
            assert code == 200 and any(
                e.get("ph") == "X" for e in fl2["traceEvents"]), text
        finally:
            _set_flags({"stack_sample_hz": 0.0})
        # fleet plane: push one snapshot to ourselves, read it back
        body = json.dumps(_fleet.local_snapshot("selftest-host"),
                          default=str).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/fleet/push", data=body,
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
        code, text = fetch("/fleet")
        assert code == 200 and "selftest_http_total 3" in text, text
        code, text = fetch("/fleet?name=selftest_")
        assert code == 200 and "selftest_http_total 3" in text, text
        assert "observability_server_port" not in text, text
        code, text = fetch("/fleet/health")
        fh = json.loads(text)
        assert code == 200 and "selftest-host" in fh["hosts"], text
        code, text = fetch("/fleet/goodput")
        assert code == 200 and "selftest-host" in \
            json.loads(text)["hosts"], text
        code, text = fetch("/fleet/alerts")
        fa = json.loads(text)
        assert code == 200 and fa["worst_state"] == "inactive", text
        assert "serving_availability" in fa["slos"] and "selftest-host" \
            in fa["slos"]["serving_availability"]["hosts"], text
        # /fleet/stacks fans back out to our own /stacks via the
        # recorded peer IP + pushed port
        code, text = fetch("/fleet/stacks")
        fs = json.loads(text)
        assert code == 200 and "selftest-host" in fs["hosts"], text
        worker = fs["hosts"]["selftest-host"]
        assert worker.get("error") is None, text
        assert any(t["name"] == "MainThread"
                   for t in worker["stacks"]["threads"]), text
    finally:
        srv.stop()
        _metrics.set_enabled(False)
        _fleet.aggregator().reset()
        _reqtrace.ring().reset()
        _seqtrace.ring().reset()
        _stepprof.ring().reset()
        _tsdb.stop()
        _tsdb.ring().reset()
        _slo.engine().reset()
        _stacks.reset()
    print("self-test OK")
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="paddle_tpu_torch live observability HTTP exporter")
    ap.add_argument("--port", type=int, default=0,
                    help="port to serve on (0 = ephemeral)")
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args()
    if args.self_test:
        return self_test()
    srv = start(args.port)
    print(f"serving /metrics /healthz /varz /trace /goodput /flight "
          f"/requests /llm/seqs /llm/steps /fleet on :{srv.port}")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
