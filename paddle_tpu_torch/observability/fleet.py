"""Fleet-wide metric federation: push, merge, and serve N hosts as one.

Counterpart of ``paddle_tpu.observability.fleet``: the same push body,
merge rules, endpoints and env names, so a port worker's push merges
into a JAX aggregator and a JAX worker's into a port one.

PRs 1–5 made every *process* observable (`/metrics`, `/goodput`,
`/flight` on each worker's exporter); a multi-host job still had no
single place to ask "what is the fleet doing right now". This module is
that plane, built the way the reference's multi-host monitor runtime
federated its stat registries (csrc/monitor.cc + the pt_mon bridge),
but over the existing stdlib HTTP exporter — no new dependency, no
collective, resilient to dead hosts:

- **Workers push.** A :class:`FleetReporter` daemon thread POSTs a
  periodic snapshot (metrics registry + goodput ledger + health +
  this worker's exporter port) to the rank-0 aggregator's
  ``/fleet/push`` endpoint every ``FLAGS_fleet_push_interval_s``
  seconds. A dead aggregator costs the worker nothing but a counted
  failure (``fleet_push_failures_total``) — training never blocks on
  telemetry.
- **Rank 0 aggregates.** The exporter's :class:`FleetAggregator` keeps
  the latest snapshot per host and merges on read: **counters are
  summed** across hosts per label set, **gauges get a ``{host=}``
  label**, and **histograms merge bucket-wise** — which is exact only
  because bucket boundaries are declared at registration
  (``metrics.LATENCY_MS_BUCKETS`` etc.); a boundary mismatch raises
  instead of silently mis-merging.
- **Discovery rides the launcher's env.** A launcher points every
  worker at rank 0 via ``PT_FLEET_AGGREGATOR`` / ``PT_FLEET_HOST``
  (the JAX package's ``distributed/launch.py`` sets them; the port's
  launcher comes with its multi-host tier); the reporter self-starts
  from that env when the exporter comes up. Explicit wiring:
  ``fleet.start_reporter("host:port", host_id="w3")``.

Endpoints (observability/server.py):

- ``POST /fleet/push``   — snapshot ingest (workers only).
- ``GET  /fleet``        — merged Prometheus text (``?format=json``
  for the JSON snapshot including per-host raw views).
- ``GET  /fleet/goodput``— fleet goodput roll-up: summed buckets, the
  fleet ``goodput_ratio`` headline, per-host badput attribution, and
  straggler events correlated per host.
- ``GET  /fleet/health`` — per-host staleness/health; **503 when any
  host is stale** (no push for ``FLAGS_fleet_stale_after_s``) — the
  merged view keeps serving the dead host's last snapshot, clearly
  aged, so a SIGKILLed worker degrades the fleet page instead of
  breaking it.
- ``GET  /fleet/alerts`` — SLO alert states merged worst-state-wins
  across hosts with per-host attribution (observability/slo.py);
  stale hosts are listed but age out of the fleet verdict.

``tools/fleet_status.py`` renders the live table of either package's
aggregator.
"""

from __future__ import annotations

import json
import logging
import os
import socket as _socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..flags import GLOBAL_FLAGS
from . import flight as _flight
from . import metrics as _metrics

_log = logging.getLogger("paddle_tpu_torch.observability")

__all__ = ["FleetReporter", "FleetAggregator", "aggregator",
           "start_reporter", "stop_reporter", "maybe_start_reporter",
           "local_snapshot", "merge_metric_snapshots",
           "merged_prometheus_text", "fleet_view", "fleet_goodput",
           "fleet_health", "fleet_alerts", "fleet_stacks",
           "default_host_id"]

# env names the launcher uses for discovery (distributed/launch.py)
AGGREGATOR_ENV = "PT_FLEET_AGGREGATOR"
HOST_ENV = "PT_FLEET_HOST"


def default_host_id() -> str:
    """Stable per-worker identity: PT_FLEET_HOST from the launcher,
    else hostname:rank (PT_TRAINER_ID), else hostname:pid."""
    hid = os.environ.get(HOST_ENV)
    if hid:
        return hid
    rank = os.environ.get("PT_TRAINER_ID")
    suffix = rank if rank is not None else str(os.getpid())
    return f"{_socket.gethostname()}:{suffix}"


def local_snapshot(host_id: Optional[str] = None) -> Dict[str, Any]:
    """One push body: this process's metrics + goodput + health view,
    stamped with its identity and exporter port (the report-back half
    of fleet discovery when ports are ephemeral)."""
    from . import goodput as _goodput
    port = 0
    g = _metrics.registry().get("observability_server_port")
    if g is not None:
        try:
            port = int(float(g.value() or 0))
        except (TypeError, ValueError):
            port = 0
    try:
        from . import server as _server
        health = _server._healthz()
    except Exception as e:  # noqa: BLE001 — health must not break a push
        health = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    try:
        from . import slo as _slo
        alerts = _slo.engine().alerts_view()
    # ptlint: disable=silent-failure -- alert evaluation must not break a push; the snapshot just ships without an alerts section
    except Exception:  # noqa: BLE001
        alerts = None
    return {"host": host_id or default_host_id(),
            "pid": os.getpid(),
            "port": port,
            "ts_unix": time.time(),
            "metrics": _metrics.registry().snapshot(),
            "goodput": _goodput.ledger().snapshot(),
            "health": health,
            "alerts": alerts}


# ---------------------------------------------------------------- merging

def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def merge_metric_snapshots(per_host: Dict[str, Dict[str, Any]]
                           ) -> Dict[str, Any]:
    """Merge per-host registry snapshots into one fleet snapshot.

    Semantics (docs/observability.md, "Fleet view"): counters are
    summed across hosts per label set; gauges keep one series per host,
    labeled ``{host=}`` (overriding any same-named source label);
    histograms are merged bucket-wise per label set — identical bucket
    boundaries are REQUIRED and a mismatch raises ``ValueError`` (the
    declarable-bucket contract in metrics.py exists so this never
    fires in a homogeneous fleet). A cross-host instrument-type clash
    also raises: one name, one type, fleet-wide.
    """
    merged: Dict[str, Any] = {}
    for host in sorted(per_host):
        snap = per_host[host] or {}
        for name, m in snap.items():
            ent = merged.setdefault(
                name, {"type": m["type"], "help": m.get("help", ""),
                       "series": {}})
            if ent["type"] != m["type"]:
                raise ValueError(
                    f"fleet merge: metric '{name}' is {ent['type']} on "
                    f"one host and {m['type']} on '{host}'")
            series = ent["series"]
            if m["type"] == "gauge":
                for s in m.get("series", []):
                    labels = dict(s["labels"])
                    labels["host"] = host
                    series[_label_key(labels)] = {
                        "labels": labels, "value": s["value"]}
            elif m["type"] == "histogram":
                for s in m.get("series", []):
                    key = _label_key(s["labels"])
                    cur = series.get(key)
                    if cur is None:
                        series[key] = {"labels": dict(s["labels"]),
                                       "count": s["count"],
                                       "sum": s["sum"],
                                       "buckets": dict(s["buckets"])}
                        continue
                    if list(cur["buckets"]) != list(s["buckets"]):
                        raise ValueError(
                            f"fleet merge: histogram '{name}' bucket "
                            f"boundaries differ on host '{host}' "
                            f"({list(s['buckets'])} vs "
                            f"{list(cur['buckets'])}) — declare one "
                            "shared scheme at registration "
                            "(metrics.LATENCY_MS_BUCKETS)")
                    for k in cur["buckets"]:
                        cur["buckets"][k] += s["buckets"][k]
                    cur["count"] += s["count"]
                    cur["sum"] += s["sum"]
            else:  # counter (and any future monotonic kind): sum
                for s in m.get("series", []):
                    key = _label_key(s["labels"])
                    cur = series.get(key)
                    if cur is None:
                        series[key] = {"labels": dict(s["labels"]),
                                       "value": s["value"]}
                    else:
                        cur["value"] += s["value"]
    # flatten the keyed series maps into the snapshot list shape
    for ent in merged.values():
        ent["series"] = [ent["series"][k] for k in sorted(ent["series"])]
    return merged


def merged_prometheus_text(merged: Dict[str, Any]) -> str:
    """Prometheus text exposition of a merged fleet snapshot (same
    format as MetricsRegistry.prometheus_text, ``fleet_`` untouched —
    series already carry their host labels where applicable)."""
    lines: List[str] = []
    for name in sorted(merged):
        ent = merged[name]
        if ent.get("help"):
            lines.append(f"# HELP {name} {ent['help']}")
        lines.append(f"# TYPE {name} {ent['type']}")
        for s in ent["series"]:
            key = _label_key(s["labels"])
            if ent["type"] == "histogram":
                for le, c in s["buckets"].items():
                    le_label = 'le="%s"' % le
                    lines.append(
                        f"{name}_bucket"
                        f"{_metrics._fmt_labels(key, le_label)} {c}")
                lines.append(
                    f"{name}_sum{_metrics._fmt_labels(key)} {s['sum']}")
                lines.append(
                    f"{name}_count{_metrics._fmt_labels(key)} "
                    f"{s['count']}")
            else:
                lines.append(
                    f"{name}{_metrics._fmt_labels(key)} {s['value']}")
    return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------------------- aggregator

class FleetAggregator:
    """Latest-snapshot-per-host store + merged views (rank 0 side)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hosts: Dict[str, Dict[str, Any]] = {}  # guarded-by: self._lock

    def ingest(self, snapshot: Dict[str, Any],
               peer: Optional[str] = None) -> str:
        """Store one pushed snapshot; returns the host id it was filed
        under. Malformed bodies raise ValueError (the HTTP handler
        answers 400). ``peer`` is the pushing socket's source IP (the
        HTTP handler passes it): together with the snapshot's exporter
        ``port`` it gives fan-out endpoints (/fleet/stacks) a dialable
        address even though host ids are display labels."""
        if not isinstance(snapshot, dict) or "host" not in snapshot:
            raise ValueError("fleet push body must be a JSON object "
                             "with a 'host' field")
        host = str(snapshot["host"])
        entry = dict(snapshot)
        entry["received_unix"] = time.time()
        entry["received_mono"] = time.monotonic()
        if peer:
            entry["peer_ip"] = str(peer)
        with self._lock:
            known = host in self._hosts
            self._hosts[host] = entry
        if not known:
            _flight.record("fleet_host_joined", force=True, host=host,
                           port=entry.get("port"))
        c = _metrics.counter(
            "fleet_snapshots_received_total",
            "worker snapshots ingested by the fleet aggregator",
            always=True)
        c.inc(host=host)
        return host

    def hosts(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._hosts)

    def forget(self, host: str) -> None:
        with self._lock:
            self._hosts.pop(host, None)

    def reset(self) -> None:
        with self._lock:
            self._hosts.clear()


_AGGREGATOR = FleetAggregator()


def aggregator() -> FleetAggregator:
    return _AGGREGATOR


def _stale_after_s() -> float:
    return float(GLOBAL_FLAGS.get("fleet_stale_after_s"))


def fleet_health() -> Tuple[bool, Dict[str, Any]]:
    """(all_fresh, payload) for /fleet/health: per-host push age and
    pushed self-health; any host older than FLAGS_fleet_stale_after_s
    is ``stale`` and flips the endpoint to 503. An empty fleet is
    healthy-but-empty (200, hosts={}) — before the first push there is
    nothing to be stale."""
    now = time.time()
    now_mono = time.monotonic()
    stale_after = _stale_after_s()
    hosts: Dict[str, Any] = {}
    ok = True
    for host, entry in sorted(aggregator().hosts().items()):
        mono0 = entry.get("received_mono")
        if mono0 is not None:
            age = max(0.0, now_mono - float(mono0))
        else:
            # ptlint: disable=clock-hygiene -- test-injected snapshots carry only the wall stamp; ingest() always adds received_mono
            age = max(0.0, now - float(entry.get("received_unix", 0)))
        stale = stale_after > 0 and age > stale_after
        healthy = bool((entry.get("health") or {}).get("ok", False))
        if stale:
            ok = False
        hosts[host] = {"age_s": round(age, 3), "stale": stale,
                       "healthy": healthy,
                       "port": entry.get("port"),
                       "pid": entry.get("pid"),
                       "last_push_unix": entry.get("received_unix")}
    return ok, {"status": "ok" if ok else "stale",
                "stale_after_s": stale_after,
                "hosts": hosts}


def fleet_view() -> Dict[str, Any]:
    """The /fleet JSON body: merged metrics + per-host meta. A merge
    error (mismatched boundaries/types) is surfaced in ``merge_error``
    while the per-host raw views stay served — federation must degrade
    readable, not blank."""
    entries = aggregator().hosts()
    per_host_metrics = {h: e.get("metrics", {})
                        for h, e in entries.items()}
    out: Dict[str, Any] = {
        "unix_time": time.time(),
        "n_hosts": len(entries),
        "hosts": {h: {"ts_unix": e.get("ts_unix"),
                      "received_unix": e.get("received_unix"),
                      "port": e.get("port"), "pid": e.get("pid")}
                  for h, e in entries.items()},
    }
    try:
        out["metrics"] = merge_metric_snapshots(per_host_metrics)
    except ValueError as e:
        out["metrics"] = {}
        out["merge_error"] = str(e)
        out["per_host_metrics"] = per_host_metrics
    _, out["health"] = fleet_health()
    return out


def fleet_prometheus_text(name_prefixes=None) -> str:
    """The /fleet Prometheus body (merged exposition).
    ``name_prefixes`` (the ``/fleet?name=`` filter) keeps only metrics
    whose name starts with any given prefix."""
    entries = aggregator().hosts()
    merged = merge_metric_snapshots(
        {h: e.get("metrics", {}) for h, e in entries.items()})
    if name_prefixes is not None:
        prefixes = tuple(p for p in name_prefixes if p)
        merged = ({n: m for n, m in merged.items()
                   if n.startswith(prefixes)} if prefixes else {})
    return merged_prometheus_text(merged)


def fleet_alerts() -> Dict[str, Any]:
    """The /fleet/alerts body: per-SLO worst-state-wins across hosts
    with per-host attribution.

    Each host's pushed snapshot carries its local ``alerts`` view
    (observability/slo.py states). The merge keeps, per SLO, every
    host's state/burn/budget and promotes the *worst* fresh state
    (firing > pending > resolved > inactive) to the fleet verdict; a
    host whose push is older than ``FLAGS_fleet_stale_after_s`` is
    listed with ``stale: true`` but does NOT drive the verdict — its
    alert state ages out the way /fleet/health ages its liveness."""
    from .slo import STATE_ORDER
    now_mono = time.monotonic()
    stale_after = _stale_after_s()
    slos: Dict[str, Any] = {}
    stale_hosts: List[str] = []
    n_reporting = 0
    for host, entry in sorted(aggregator().hosts().items()):
        mono0 = entry.get("received_mono")
        age = (max(0.0, now_mono - float(mono0))
               if mono0 is not None else float("inf"))
        stale = stale_after > 0 and age > stale_after
        if stale:
            stale_hosts.append(host)
        view = entry.get("alerts") or {}
        alerts = view.get("alerts") or []
        if alerts and not stale:
            n_reporting += 1
        for a in alerts:
            name = a.get("slo")
            state = a.get("state", "inactive")
            if name is None or state not in STATE_ORDER:
                continue
            ent = slos.setdefault(
                name, {"state": "inactive", "firing_hosts": [],
                       "hosts": {}})
            ent["hosts"][host] = {
                "state": state,
                "stale": stale,
                "push_age_s": round(age, 3),
                "budget_remaining": a.get("budget_remaining"),
                "trigger_pair": a.get("trigger_pair"),
                "age_s": a.get("age_s"),
            }
            if stale:
                continue
            if (STATE_ORDER.index(state)
                    > STATE_ORDER.index(ent["state"])):
                ent["state"] = state
            if state == "firing":
                ent["firing_hosts"].append(host)
    worst = "inactive"
    for ent in slos.values():
        if STATE_ORDER.index(ent["state"]) > STATE_ORDER.index(worst):
            worst = ent["state"]
    return {"unix_time": time.time(),
            "n_hosts": len(aggregator().hosts()),
            "n_reporting": n_reporting,
            "worst_state": worst,
            "stale_after_s": stale_after,
            "stale_hosts": stale_hosts,
            "slos": slos}


def fleet_stacks(top_n: int = 16,
                 timeout_s: float = 2.0) -> Dict[str, Any]:
    """The /fleet/stacks body: fan the live ``GET /stacks`` question
    out to every registered worker and merge the answers.

    Unlike the other fleet views this is a *pull*, not a merge of
    pushed state — stacks must be captured at ask-time to be worth
    anything, and a wedged worker's push loop may itself be stuck
    while its exporter thread still answers. Each worker is dialed at
    its push source IP (recorded at ingest) + its pushed exporter
    port with a short timeout; a worker that cannot be reached
    degrades to a per-host ``error`` entry instead of failing the
    endpoint."""
    import urllib.request
    hosts: Dict[str, Any] = {}
    for host, entry in sorted(aggregator().hosts().items()):
        port = entry.get("port") or 0
        ip = entry.get("peer_ip") or "127.0.0.1"
        rec: Dict[str, Any] = {"port": port, "ip": ip,
                               "error": None, "stacks": None}
        try:
            port = int(port)
        except (TypeError, ValueError):
            port = 0
        if port <= 0:
            rec["error"] = "no exporter port in last push"
            hosts[host] = rec
            continue
        try:
            with urllib.request.urlopen(
                    f"http://{ip}:{port}/stacks?n={int(top_n)}",
                    timeout=timeout_s) as r:
                rec["stacks"] = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 — degrade per host
            rec["error"] = f"{type(e).__name__}: {e}"
        hosts[host] = rec
    return {"unix_time": time.time(),
            "n_hosts": len(hosts),
            "hosts": hosts}


def _straggler_counts(metrics_snap: Dict[str, Any]) -> float:
    total = 0.0
    ent = (metrics_snap or {}).get("straggler_events_total")
    for s in (ent or {}).get("series", []):
        total += float(s.get("value", 0))
    return total


def fleet_goodput() -> Dict[str, Any]:
    """The /fleet/goodput body: fleet-summed ledger buckets, the fleet
    goodput headline, per-host badput attribution (each host's buckets,
    ratios, and its worst non-goodput bucket), and straggler events
    correlated per host — the "who is wasting the fleet's time" page.
    """
    from .goodput import BUCKETS, GOODPUT_BUCKET
    entries = aggregator().hosts()
    fleet_buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
    hosts: Dict[str, Any] = {}
    wall_total = 0.0
    for host, entry in sorted(entries.items()):
        gp = entry.get("goodput") or {}
        buckets = {b: float((gp.get("buckets") or {}).get(b, 0.0))
                   for b in BUCKETS}
        wall = float(gp.get("wall_seconds", 0.0))
        wall_total += wall
        for b, s in buckets.items():
            fleet_buckets[b] += s
        badput = {b: s for b, s in buckets.items()
                  if b != GOODPUT_BUCKET and s > 0}
        worst = max(badput, key=badput.get) if badput else None
        hosts[host] = {
            "wall_seconds": wall,
            "goodput_ratio": float(gp.get("goodput_ratio", 0.0)),
            "buckets": buckets,
            "worst_badput_bucket": worst,
            "straggler_events": _straggler_counts(
                entry.get("metrics")),
        }
    ratio = (fleet_buckets[GOODPUT_BUCKET] / wall_total
             if wall_total > 0 else 0.0)
    return {"unix_time": time.time(),
            "n_hosts": len(entries),
            "wall_seconds": wall_total,
            "buckets": fleet_buckets,
            "goodput_ratio": ratio,
            "hosts": hosts}


# --------------------------------------------------------------- reporter

class FleetReporter:
    """Daemon push loop: POST local_snapshot() to the aggregator every
    ``interval_s`` seconds. Failures are counted, logged once per
    outage, and never raised — the aggregator dying must cost the
    worker nothing (docs/observability.md, "Fleet view")."""

    def __init__(self, aggregator_addr: str,
                 host_id: Optional[str] = None,
                 interval_s: Optional[float] = None) -> None:
        addr = aggregator_addr.strip()
        if "//" in addr:  # tolerate a full URL
            addr = addr.split("//", 1)[1]
        self.aggregator_addr = addr.rstrip("/")
        self.host_id = host_id or default_host_id()
        if interval_s is None:
            interval_s = float(GLOBAL_FLAGS.get("fleet_push_interval_s"))
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._failing = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pt-fleet-reporter")
        self._thread.start()

    def push_once(self, timeout_s: float = 5.0) -> bool:
        """One synchronous push; True on HTTP 2xx. Public so tests and
        shutdown paths can force a final snapshot out."""
        import urllib.request
        body = json.dumps(local_snapshot(self.host_id),
                          default=str).encode()
        req = urllib.request.Request(
            f"http://{self.aggregator_addr}/fleet/push", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                ok = 200 <= r.status < 300
        except Exception as e:  # noqa: BLE001 — push must never raise
            if not self._failing:
                self._failing = True
                _log.warning(
                    "fleet push to %s failing (%s: %s) — will keep "
                    "retrying every %.1fs (logged once per outage)",
                    self.aggregator_addr, type(e).__name__, e,
                    self.interval_s)
            _metrics.counter(
                "fleet_push_failures_total",
                "snapshot pushes that could not reach the fleet "
                "aggregator (it may be down — workers never block on "
                "telemetry)", always=True).inc()
            return False
        if ok:
            if self._failing:
                _log.info("fleet push to %s recovered",
                          self.aggregator_addr)
            self._failing = False
            _metrics.counter(
                "fleet_pushes_total",
                "snapshot pushes accepted by the fleet aggregator",
                always=True).inc()
        return ok

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.push_once()
        self.push_once(timeout_s=1.0)  # final snapshot on clean stop

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


_reporter_lock = threading.Lock()
_reporter: Optional[FleetReporter] = None  # guarded-by: _reporter_lock


def start_reporter(aggregator_addr: str,
                   host_id: Optional[str] = None,
                   interval_s: Optional[float] = None) -> FleetReporter:
    """Start (or return) the process-wide reporter. Idempotent like
    server.start(): one worker, one push loop."""
    global _reporter
    with _reporter_lock:
        if _reporter is None:
            _reporter = FleetReporter(aggregator_addr, host_id,
                                      interval_s)
            _log.info("fleet reporter pushing to %s as host '%s' every "
                      "%.1fs", _reporter.aggregator_addr,
                      _reporter.host_id, _reporter.interval_s)
        return _reporter


def reporter() -> Optional[FleetReporter]:
    return _reporter


def stop_reporter() -> None:
    global _reporter
    with _reporter_lock:
        if _reporter is not None:
            _reporter.stop()
            _reporter = None


def maybe_start_reporter() -> Optional[FleetReporter]:
    """Env-driven start, called when the exporter comes up
    (server.maybe_start): PT_FLEET_AGGREGATOR names the rank-0
    aggregator (set by launch_procs/launch_elastic) and metrics are
    on. Rank 0 pushes to itself over loopback — one uniform path, so
    the aggregator host appears in its own /fleet view."""
    addr = os.environ.get(AGGREGATOR_ENV, "").strip()
    if not addr or not _metrics.enabled():
        return _reporter
    return start_reporter(addr)
