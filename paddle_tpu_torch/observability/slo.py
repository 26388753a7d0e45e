"""Declarative SLOs evaluated as multi-window multi-burn-rate alerts.

Counterpart of ``paddle_tpu.observability.slo``: the same spec kinds,
window pairs, state machine, default pack, gauges and payloads.

An :class:`SLOSpec` states an objective over metrics the registry
already holds:

- ``ratio``   — ``good_expr / total_expr >= target``, where each
  expression is a ``+``/``-`` combination of counter names (summed
  across label sets), e.g. availability = (requests − shed − errors)
  / (requests + rejected) ≥ 0.999;
- ``latency`` — ``target`` fraction of a latency histogram's
  observations must land at or under ``threshold_ms`` (i.e. "p99 TTFT
  ≤ 1000 ms" is target=0.99, threshold_ms=1000); internally this is a
  ratio whose good-count is the bucket-interpolated cumulative count
  at the threshold;
- ``absence`` — a counter that must never move (audit failures,
  nonfinite steps); any windowed increase is burn.

Evaluation follows the SRE multi-window multi-burn-rate recipe: the
error-budget *burn rate* over a window is
``bad_fraction(window) / (1 − target)`` (1.0 = exactly spending the
budget), and an alert pair fires only when BOTH its short and long
window exceed the pair's threshold — the long window provides
significance, the short one fast reset. Two pairs ship:

====  ===========  ==========  =========  ========
pair  short        long        threshold  severity
====  ===========  ==========  =========  ========
fast  5 m          1 h         14.4       page
slow  30 m         6 h         6.0        ticket
====  ===========  ==========  =========  ========

All four windows scale by ``FLAGS_slo_window_scale`` so tests and the
chaos drill run the same arithmetic in seconds instead of hours.

Each spec carries an explicit alert state machine::

    inactive -> pending   (one window of a pair over threshold)
    pending  -> firing    (both windows of a pair over)
    firing   -> resolved  (no pair fully over any more)
    resolved -> inactive  (quiet for 2x the fast short window)
    resolved -> firing    (re-trip)

Every transition lands in the crash flight recorder
(``slo_alert`` events, force=True) and increments
``slo_alert_transitions_total{slo=,to=}``; current state, per-window
burn rates and budget remaining are published as gauges and served by
the exporter's ``/alerts`` and ``/slo`` endpoints (fleet-merged on
rank-0 as ``/fleet/alerts``).

Error-budget accounting is *exact*, computed from lifetime registry
values, not samples: ``remaining = 1 − bad/((1 − target) · total)``
— the fraction of the budget still unspent over the process lifetime.
Per-alert transition history is a bounded deque
(:data:`TRANSITION_CAP`), rotation eviction like every other ring.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..flags import GLOBAL_FLAGS
from . import flight as _flight
from . import metrics as _metrics
from . import tsdb as _tsdb

__all__ = ["SLOSpec", "SloEngine", "engine", "WINDOW_PAIRS",
           "TRANSITION_CAP", "STATE_ORDER", "ensure_default_pack"]

# (pair name, short window s, long window s, burn threshold, severity)
# — the Google SRE workbook's recommended pairs; scaled by
# FLAGS_slo_window_scale at evaluation time.
WINDOW_PAIRS: Tuple[Tuple[str, float, float, float, str], ...] = (
    ("fast", 300.0, 3600.0, 14.4, "page"),
    ("slow", 1800.0, 21600.0, 6.0, "ticket"),
)

# per-alert transition-history bound (rotation eviction)
TRANSITION_CAP = 256

# severity order for worst-state-wins fleet merges
STATE_ORDER = ("inactive", "resolved", "pending", "firing")


def _window_scale() -> float:
    return max(1e-6, float(GLOBAL_FLAGS.get("slo_window_scale")))


# -- counter expressions ----------------------------------------------

def _parse_expr(expr: str) -> List[Tuple[float, str]]:
    """``"a + b - c"`` → ``[(+1, a), (+1, b), (-1, c)]``. Only ``+``
    and ``-`` over metric names — an SLO is a ratio of event counts,
    not a query language."""
    terms: List[Tuple[float, str]] = []
    sign = 1.0
    for tok in expr.replace("+", " + ").replace("-", " - ").split():
        if tok == "+":
            sign = 1.0
        elif tok == "-":
            sign = -1.0
        else:
            terms.append((sign, tok))
            sign = 1.0
    if not terms:
        raise ValueError(f"empty SLO expression: {expr!r}")
    return terms


class SLOSpec:
    """One declarative objective; see the module docstring for kinds."""

    def __init__(self, name: str, kind: str, target: float,
                 good: Optional[str] = None, total: Optional[str] = None,
                 hist: Optional[str] = None,
                 threshold_ms: Optional[float] = None,
                 counter: Optional[str] = None,
                 description: str = "") -> None:
        if kind not in ("ratio", "latency", "absence"):
            raise ValueError(f"unknown SLO kind: {kind!r}")
        if kind == "ratio" and not (good and total):
            raise ValueError(f"ratio SLO {name!r} needs good= and total=")
        if kind == "latency" and not (hist and threshold_ms is not None):
            raise ValueError(
                f"latency SLO {name!r} needs hist= and threshold_ms=")
        if kind == "absence" and not counter:
            raise ValueError(f"absence SLO {name!r} needs counter=")
        if not (0.0 < float(target) <= 1.0):
            raise ValueError(f"SLO {name!r} target must be in (0, 1]")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.good = _parse_expr(good) if good else None
        self.total = _parse_expr(total) if total else None
        self.hist = hist
        self.threshold_ms = (None if threshold_ms is None
                             else float(threshold_ms))
        self.counter = counter
        self.description = description

    def metric_names(self) -> List[str]:
        names: List[str] = []
        for terms in (self.good, self.total):
            if terms:
                names.extend(n for _, n in terms)
        if self.hist:
            names.append(self.hist)
        if self.counter:
            names.append(self.counter)
        return sorted(set(names))

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name, "kind": self.kind,
                             "target": self.target,
                             "description": self.description}
        if self.good:
            d["good"] = " + ".join(
                ("-" if s < 0 else "") + n for s, n in self.good
            ).replace("+ -", "- ")
        if self.total:
            d["total"] = " + ".join(
                ("-" if s < 0 else "") + n for s, n in self.total
            ).replace("+ -", "- ")
        if self.hist:
            d["hist"] = self.hist
            d["threshold_ms"] = self.threshold_ms
        if self.counter:
            d["counter"] = self.counter
        return d

    # -- good/bad/total over a window or over the lifetime ------------

    def _eval_terms(self, terms: Sequence[Tuple[float, str]],
                    lookup) -> float:
        return float(sum(s * lookup(n) for s, n in terms))

    def window_counts(self, ring: "_tsdb.TsdbRing", window_s: float,
                      now: Optional[float]) -> Tuple[float, float]:
        """(bad, total) event counts inside the window."""
        if self.kind == "ratio":
            inc = lambda n: ring.increase(n, window_s, now)
            total = self._eval_terms(self.total, inc)
            good = self._eval_terms(self.good, inc)
            return max(0.0, total - good), max(0.0, total)
        if self.kind == "latency":
            d = ring.hist_increase(self.hist, window_s, now)
            if d is None or d["count"] <= 0:
                return 0.0, 0.0
            good = _interp_cum_count(d["bounds"], d["counts"],
                                     d["count"], self.threshold_ms)
            return max(0.0, d["count"] - good), float(d["count"])
        # absence: every increment is a bad event out of itself — any
        # movement at all is an infinite-rate burn against a zero
        # budget; report (bad, bad) and let burn_rate special-case it.
        bad = ring.increase(self.counter, window_s, now)
        return max(0.0, bad), max(0.0, bad)

    def lifetime_counts(self) -> Tuple[float, float]:
        """(bad, total) over the process lifetime, straight from the
        registry — the exact error-budget basis."""
        reg = _metrics.registry()

        def val(n: str) -> float:
            m = reg.get(n)
            if m is None:
                return 0.0
            if m.kind == "histogram":
                snap = m._snapshot()
                return float(sum(s["count"] for s in snap))
            return float(sum(s["value"] for s in m._snapshot()))

        if self.kind == "ratio":
            total = self._eval_terms(self.total, val)
            good = self._eval_terms(self.good, val)
            return max(0.0, total - good), max(0.0, total)
        if self.kind == "latency":
            m = reg.get(self.hist)
            if m is None or m.kind != "histogram":
                return 0.0, 0.0
            counts = [0.0] * len(m.buckets)
            count = 0
            for s in m._snapshot():
                for i, b in enumerate(m.buckets):
                    counts[i] += s["buckets"].get(str(b), 0)
                count += s["count"]
            if count <= 0:
                return 0.0, 0.0
            good = _interp_cum_count(tuple(m.buckets), tuple(counts),
                                     count, self.threshold_ms)
            return max(0.0, count - good), float(count)
        bad = val(self.counter)
        return max(0.0, bad), max(0.0, bad)

    def burn_rate(self, bad: float, total: float) -> float:
        """Error-budget burn rate for a window's (bad, total); 1.0
        means spending exactly the budget."""
        if self.kind == "absence":
            # zero-tolerance objective: any bad event is already an
            # over-threshold burn (represented as a large finite rate
            # so JSON stays clean)
            return 1e9 if bad > 0 else 0.0
        if total <= 0:
            return 0.0
        budget = 1.0 - self.target
        if budget <= 0:
            return 1e9 if bad > 0 else 0.0
        return (bad / total) / budget

    def budget_remaining(self) -> float:
        """Exact lifetime error-budget fraction remaining:
        ``1 − bad/((1 − target) · total)`` (may go negative when the
        budget is blown; 1.0 before any traffic)."""
        bad, total = self.lifetime_counts()
        if self.kind == "absence":
            return 0.0 if bad > 0 else 1.0
        budget_events = (1.0 - self.target) * total
        if budget_events <= 0:
            return 1.0 if bad <= 0 else 0.0
        return 1.0 - bad / budget_events


def _interp_cum_count(bounds: Sequence[float], counts: Sequence[float],
                      count: float, threshold: float) -> float:
    """Observations at or under ``threshold`` estimated from cumulative
    bucket counts, linearly interpolating inside the straddling bucket
    (the inverse read of metrics.quantile_from_buckets)."""
    prev_bound, prev_cum = 0.0, 0.0
    for b, c in zip(bounds, counts):
        if threshold <= b:
            if b == prev_bound:
                return float(c)
            frac = (threshold - prev_bound) / (b - prev_bound)
            return prev_cum + (c - prev_cum) * max(0.0, min(1.0, frac))
        prev_bound, prev_cum = b, c
    return float(count)  # threshold above the top finite boundary


class _AlertState:
    """Mutable per-spec alert record (engine-lock guarded)."""

    def __init__(self) -> None:
        self.state = "inactive"
        self.since_mono = time.monotonic()
        self.resolved_mono: Optional[float] = None
        self.transitions: deque = deque(maxlen=TRANSITION_CAP)
        self.windows: Dict[str, Any] = {}
        self.trigger: Optional[str] = None


class SloEngine:
    """Registered specs + their alert state machines."""

    def __init__(self, ring: Optional["_tsdb.TsdbRing"] = None) -> None:
        self._lock = threading.Lock()
        self._ring = ring or _tsdb.ring()
        self._specs: Dict[str, SLOSpec] = {}  # guarded-by: self._lock
        self._alerts: Dict[str, _AlertState] = {}  # guarded-by: self._lock
        self._defaults_installed = False  # guarded-by: self._lock

    def register(self, spec: SLOSpec) -> SLOSpec:
        """Add (or replace) a spec; its metrics join the tsdb watch
        set so windows start filling immediately."""
        with self._lock:
            self._specs[spec.name] = spec
            self._alerts.setdefault(spec.name, _AlertState())
        self._ring.watch(*spec.metric_names())
        return spec

    def specs(self) -> List[SLOSpec]:
        with self._lock:
            return [self._specs[k] for k in sorted(self._specs)]

    def reset(self) -> None:
        with self._lock:
            self._specs.clear()
            self._alerts.clear()
            self._defaults_installed = False

    # -- evaluation ---------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Walk every spec's window pairs against the tsdb ring,
        advance its state machine, publish gauges, and return the
        alert views (the /alerts payload)."""
        t_now = time.monotonic() if now is None else float(now)
        scale = _window_scale()
        out: List[Dict[str, Any]] = []
        for spec in self.specs():
            windows: Dict[str, Any] = {}
            pair_over: Dict[str, bool] = {}
            any_over = False
            for pname, short_s, long_s, threshold, severity in WINDOW_PAIRS:
                rates = {}
                for wname, wsec in (("short", short_s * scale),
                                    ("long", long_s * scale)):
                    bad, total = spec.window_counts(
                        self._ring, wsec, t_now)
                    rates[wname] = {
                        "window_s": wsec,
                        "bad": bad, "total": total,
                        "burn_rate": spec.burn_rate(bad, total),
                    }
                over_short = rates["short"]["burn_rate"] > threshold
                over_long = rates["long"]["burn_rate"] > threshold
                pair_over[pname] = over_short and over_long
                any_over = any_over or over_short or over_long
                windows[pname] = {"threshold": threshold,
                                  "severity": severity,
                                  "short": rates["short"],
                                  "long": rates["long"],
                                  "over": pair_over[pname]}
            firing_pair = next(
                (p for p in pair_over if pair_over[p]), None)
            out.append(self._advance(spec, windows, firing_pair,
                                     any_over, t_now, scale))
        return out

    def _advance(self, spec: SLOSpec, windows: Dict[str, Any],
                 firing_pair: Optional[str], any_over: bool,
                 t_now: float, scale: float) -> Dict[str, Any]:
        hold_s = 2.0 * WINDOW_PAIRS[0][1] * scale  # 2x fast short
        with self._lock:
            st = self._alerts.setdefault(spec.name, _AlertState())
            old = st.state
            new = old
            if firing_pair is not None:
                new = "firing"
            elif old == "firing":
                new = "resolved"
            elif old == "resolved":
                if any_over:
                    new = "pending"
                elif (st.resolved_mono is not None
                      and t_now - st.resolved_mono >= hold_s):
                    new = "inactive"
            elif any_over:
                new = "pending"
            else:
                new = "inactive"
            if new != old:
                st.state = new
                st.since_mono = t_now
                st.resolved_mono = (t_now if new == "resolved"
                                    else None)
                st.trigger = firing_pair if new == "firing" else st.trigger
                transition = {"t_mono": t_now, "from": old, "to": new,
                              "pair": firing_pair}
                st.transitions.append(transition)
            else:
                transition = None
            st.windows = windows
            state = st.state
            since = st.since_mono
            trigger = st.trigger
            n_transitions = len(st.transitions)
        budget = spec.budget_remaining()
        if transition is not None:
            _flight.record(
                "slo_alert", force=True, slo=spec.name,
                from_state=transition["from"], to_state=transition["to"],
                pair=transition["pair"],
                budget_remaining=budget)
            _metrics.counter(
                "slo_alert_transitions_total",
                "alert state-machine transitions "
                "(slo=<spec>, to=<new state>)").inc(
                    slo=spec.name, to=transition["to"])
        _metrics.gauge(
            "slo_alert_state",
            "numeric alert state per SLO (0 inactive, 1 pending, "
            "2 firing, 3 resolved)").set(
                float({"inactive": 0, "pending": 1, "firing": 2,
                       "resolved": 3}[state]), slo=spec.name)
        for pname, w in windows.items():
            for wname in ("short", "long"):
                _metrics.gauge(
                    "slo_burn_rate",
                    "observed error-budget burn rate per SLO window "
                    "(slo=<spec>, window=<pair>_<short|long>)").set(
                        w[wname]["burn_rate"], slo=spec.name,
                        window=f"{pname}_{wname}")
        _metrics.gauge(
            "slo_error_budget_remaining_ratio",
            "exact lifetime error-budget fraction remaining per SLO "
            "(1 − bad/((1 − target)·total); negative = blown)").set(
                budget, slo=spec.name)
        return {"slo": spec.name, "state": state,
                "since_mono": since, "age_s": t_now - since,
                "trigger_pair": trigger,
                "budget_remaining": budget,
                "windows": windows,
                "transitions": n_transitions}

    # -- views --------------------------------------------------------

    def alerts_view(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The /alerts payload: one evaluation pass + transition
        history tails."""
        alerts = self.evaluate(now)
        with self._lock:
            history = {name: list(st.transitions)
                       for name, st in self._alerts.items()}
        for a in alerts:
            a["history"] = history.get(a["slo"], [])
        worst = "inactive"
        for a in alerts:
            if STATE_ORDER.index(a["state"]) > STATE_ORDER.index(worst):
                worst = a["state"]
        return {"worst_state": worst, "alerts": alerts,
                "transition_cap": TRANSITION_CAP}

    def slo_view(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The /slo payload: specs + exact lifetime compliance."""
        alerts = {a["slo"]: a for a in self.evaluate(now)}
        out = []
        for spec in self.specs():
            bad, total = spec.lifetime_counts()
            compliance = (1.0 if total <= 0
                          else max(0.0, (total - bad) / total))
            out.append({
                "spec": spec.to_dict(),
                "lifetime": {"bad": bad, "total": total,
                             "compliance": compliance},
                "budget_remaining": spec.budget_remaining(),
                "state": alerts[spec.name]["state"],
            })
        return {"slos": out, "window_pairs": [
            {"pair": p, "short_s": s, "long_s": l, "threshold": t,
             "severity": sev} for p, s, l, t, sev in WINDOW_PAIRS],
            "window_scale": _window_scale()}

    # -- default pack -------------------------------------------------

    def ensure_default_pack(self) -> None:
        """Install the shipped SLO pack once (idempotent; explicit
        registrations with the same names win if made first)."""
        with self._lock:
            if self._defaults_installed:
                return
            self._defaults_installed = True
            existing = set(self._specs)
        for spec in _default_pack():
            if spec.name not in existing:
                self.register(spec)


def _default_pack() -> List[SLOSpec]:
    return [
        SLOSpec(
            "serving_availability", "ratio", target=0.999,
            good=("serving_stream_requests_total "
                  "- requests_shed_total - serving_stream_errors_total"),
            total=("serving_stream_requests_total "
                   "+ llm_admission_rejected_total"),
            description="streamed requests that were admitted and "
                        "finished without shed or execute error"),
        SLOSpec(
            "serving_ttft_p99", "latency", target=0.99,
            hist="serving_ttft_ms", threshold_ms=1000.0,
            description="99% of first tokens within 1 s of ingress"),
        SLOSpec(
            "serving_tpot_p99", "latency", target=0.99,
            hist="serving_tpot_ms", threshold_ms=250.0,
            description="99% of decode-token gaps within 250 ms"),
        SLOSpec(
            "admission_rejection_rate", "ratio", target=0.95,
            good="serving_stream_requests_total",
            total=("serving_stream_requests_total "
                   "+ llm_admission_rejected_total"),
            description="at most 5% of arrivals bounced by the KV "
                        "admission watermark"),
        SLOSpec(
            "kv_audit_clean", "absence",
            counter="llm_kv_audit_failures_total", target=1.0,
            description="the paged-KV audit must never fail"),
        SLOSpec(
            "train_goodput_ratio", "ratio", target=0.90,
            good="goodput_seconds_total",
            total="goodput_seconds_total + badput_seconds_total",
            description="at least 90% of training wall time spent in "
                        "the step itself"),
        SLOSpec(
            "train_nonfinite", "absence",
            counter="nonfinite_steps_total", target=1.0,
            description="no skipped nonfinite training steps"),
    ]


_ENGINE = SloEngine()


def engine() -> SloEngine:
    return _ENGINE


def ensure_default_pack() -> None:
    _ENGINE.ensure_default_pack()
