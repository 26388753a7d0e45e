"""Typed metrics registry: counters, gauges, bucketed histograms.

Counterpart of ``paddle_tpu.observability.metrics``, the same names,
label sets, bucket schemes and exposition bytes: labeled series,
histograms for latency distributions, a Prometheus-style text
exposition plus a JSON snapshot, and a global on/off switch
(FLAGS_enable_metrics) whose off state is one cached boolean test.

Instruments created with ``always=True`` record regardless of the flag
(an explicit user call, or a counter a drill must always see, such as
``faults_injected_total``); framework-internal hooks use the default
gated instruments.

Gauges may store device tensors (e.g. the live loss on the card): values
are kept as handed in and only ``float()``-ed at snapshot/exposition
time, so setting a gauge in a hot loop never forces a host sync.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "counter", "gauge", "histogram",
           "enabled", "set_enabled", "DEFAULT_BUCKETS",
           "LATENCY_MS_BUCKETS", "quantile_from_buckets", "percentile"]

# Module-level enabled cache: read on every instrument write, so it must
# be one attribute load — FLAGS_enable_metrics keeps it in sync via its
# on_change hook (flags.py) and the import-time read below.
_ENABLED = False


def enabled() -> bool:
    """Whether gated instruments record (FLAGS_enable_metrics)."""
    return _ENABLED


def set_enabled(value: bool) -> None:
    global _ENABLED
    _ENABLED = bool(value)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _as_float(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def quantile_from_buckets(buckets: Any, q: float) -> float:
    """Prometheus ``histogram_quantile``-style estimate from cumulative
    bucket counts.

    ``buckets`` is either the snapshot-dict shape a :class:`Histogram`
    series exposes (``{"0.5": 3, "1.0": 7, ..., "+Inf": 9}``) or a
    ``(boundaries, cumulative_counts)`` pair where the last boundary may
    be ``inf``. Returns the linearly interpolated value at quantile
    ``q`` in [0, 1] (each bucket's mass spread uniformly across its
    span, the Prometheus convention), ``nan`` when the histogram is
    empty. The quantile landing in the ``+Inf`` bucket clamps to the
    highest finite boundary — the estimator cannot see past it.

    This is the ONE shared bucket-percentile estimator: the report CLIs
    (serving_report / fleet_status), the tsdb window quantiles, and the
    SLO latency objectives all call it so their numbers agree.
    """
    if isinstance(buckets, dict):
        pairs = [(float("inf") if k == "+Inf" else float(k), float(c))
                 for k, c in buckets.items()]
    else:
        bounds, counts = buckets
        pairs = [(float(b), float(c)) for b, c in zip(bounds, counts)]
    pairs.sort()
    if not pairs:
        return float("nan")
    total = pairs[-1][1]
    if total <= 0:
        return float("nan")
    q = min(1.0, max(0.0, float(q)))
    rank = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in pairs:
        if cum >= rank:
            if bound == float("inf"):
                # cannot interpolate into the open-ended bucket; clamp
                # to the highest finite boundary (Prometheus does too)
                return prev_bound
            if cum <= prev_cum:
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + (bound - prev_bound) * frac
        prev_bound, prev_cum = (0.0 if bound == float("inf")
                                else bound), cum
    return pairs[-1][0]


def percentile(vals: Sequence[float], pct: float) -> float:
    """Linear-interpolation percentile of raw samples (``pct`` in
    [0, 100]); ``nan`` on an empty sequence. Shared by the report CLIs
    so their list-based percentiles agree with each other."""
    xs = sorted(float(v) for v in vals)
    if not xs:
        return float("nan")
    if len(xs) == 1:
        return xs[0]
    pos = (min(100.0, max(0.0, float(pct))) / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class _Instrument:
    """Shared base: name/help/lock + the enabled gate."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 always: bool = False) -> None:
        self.name = name
        self.help = help
        self._lock = lock
        self._always = always

    def _on(self) -> bool:
        return self._always or _ENABLED


class Counter(_Instrument):
    """Monotonic counter with optional labels (ref: STAT_ADD)."""

    kind = "counter"

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._series: Dict[Tuple, float] = {}  # guarded-by: self._lock

    def inc(self, value: float = 1, **labels) -> None:
        if not self._on():
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def total(self, **labels) -> float:
        """Sum across every series whose labels contain ``labels`` as
        a subset — the roll-up readers need once a counter gains a
        new label dimension (e.g. requests_shed_total{kind=,tenant=}:
        ``total(kind="stream")`` sums over tenants)."""
        want = {k: str(v) for k, v in labels.items()}
        with self._lock:
            items = list(self._series.items())
        out = 0.0
        for key, v in items:
            have = dict(key)
            if all(have.get(k) == lv for k, lv in want.items()):
                out += v
        return out

    # compat for the old StatRegistry.set() (monitor.h allowed it);
    # not part of the counter contract proper.
    def set_total(self, value: float, **labels) -> None:
        if not self._on():
            return
        with self._lock:
            self._series[_label_key(labels)] = value

    def _snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._series.items())
        return [{"labels": dict(k), "value": v} for k, v in items]


class Gauge(_Instrument):
    """Last-value instrument; values may be lazy (device arrays)."""

    kind = "gauge"

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._series: Dict[Tuple, Any] = {}  # guarded-by: self._lock

    def set(self, value: Any, **labels) -> None:
        if not self._on():
            return
        with self._lock:
            self._series[_label_key(labels)] = value

    def set_max(self, value: Any, **labels) -> None:
        """Watermark semantics: keep the running maximum."""
        if not self._on():
            return
        key = _label_key(labels)
        v = _as_float(value)
        with self._lock:
            old = self._series.get(key)
            if old is None or _as_float(old) < v:
                self._series[key] = v

    def add(self, delta: float, **labels) -> None:
        if not self._on():
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = _as_float(self._series.get(key, 0)) + delta

    def value(self, **labels) -> Any:
        with self._lock:
            return self._series.get(_label_key(labels))

    def _snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._series.items())
        return [{"labels": dict(k), "value": _as_float(v)}
                for k, v in items]


DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Shared fixed-boundary scheme for millisecond latency histograms
# (serving_*_ms and anything else fleet-federated): every host using the
# same declared boundaries is what makes the cross-host bucket-wise
# merge in observability/fleet.py exact rather than approximate.
LATENCY_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                      10000.0)


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 always: bool = False,
                 buckets: Optional[Sequence[float]] = None) -> None:
        super().__init__(name, help, lock, always)
        self.buckets = tuple(sorted(
            float(b) for b in (buckets or DEFAULT_BUCKETS)))
        self._series: Dict[Tuple, Dict[str, Any]] = {}  # guarded-by: self._lock

    def observe(self, value: float, **labels) -> None:
        if not self._on():
            return
        v = _as_float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"counts": [0] * len(self.buckets), "sum": 0.0,
                     "count": 0}
                self._series[key] = s
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s["counts"][i] += 1
            s["sum"] += v
            s["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s["count"] if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s["sum"] if s else 0.0

    def _snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = [(k, dict(s, counts=list(s["counts"])))
                     for k, s in self._series.items()]
        out = []
        for k, s in items:
            # observe() increments every bucket with le >= v, so counts
            # are already cumulative (Prometheus bucket semantics)
            buckets = {str(b): c
                       for b, c in zip(self.buckets, s["counts"])}
            buckets["+Inf"] = s["count"]
            out.append({"labels": dict(k), "count": s["count"],
                        "sum": s["sum"], "buckets": buckets})
        return out


class MetricsRegistry:
    """Thread-safe named instrument registry.

    ``counter``/``gauge``/``histogram`` are idempotent: the first call
    creates the instrument, later calls return it (a mismatched kind
    raises — one name, one type).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}  # guarded-by: self._lock

    def _get_or_make(self, cls, name: str, help: str, always: bool,
                     **kwargs) -> _Instrument:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, threading.Lock(), always, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                always: bool = False) -> Counter:
        return self._get_or_make(Counter, name, help, always)

    def gauge(self, name: str, help: str = "",
              always: bool = False) -> Gauge:
        return self._get_or_make(Gauge, name, help, always)

    def histogram(self, name: str, help: str = "", always: bool = False,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Bucket boundaries are part of the instrument's declaration:
        the first registration fixes them (``None`` → DEFAULT_BUCKETS);
        a later registration that declares *different* boundaries
        raises — silently returning the old instrument would mis-merge
        fleet-federated bucket counts (observability/fleet.py).
        ``buckets=None`` on an existing histogram means "whatever was
        declared" and never conflicts."""
        h = self._get_or_make(Histogram, name, help, always,
                              buckets=buckets)
        if buckets is not None:
            declared = tuple(sorted(float(b) for b in buckets))
            if declared != h.buckets:
                raise ValueError(
                    f"histogram '{name}' already declared with buckets "
                    f"{h.buckets}; re-registration with {declared} "
                    "would silently mis-merge — use one shared "
                    "boundary scheme (e.g. metrics.LATENCY_MS_BUCKETS)")
        return h

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every instrument (tests / fresh runs)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: {name: {type, help, series|histogram data}}."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: {"type": m.kind, "help": m.help,
                       "series": m._snapshot()}
                for name, m in metrics}

    def snapshot_json(self, indent: int = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def prometheus_text(
            self, name_prefixes: Optional[Sequence[str]] = None) -> str:
        """Prometheus text exposition format.

        ``name_prefixes`` (the exporter's ``/metrics?name=`` filter and
        the tsdb sampler's fetch) keeps only metrics whose name starts
        with any given prefix; the output stays valid exposition text.
        """
        with self._lock:
            metrics = list(self._metrics.items())
        if name_prefixes is not None:
            prefixes = tuple(p for p in name_prefixes if p)
            metrics = [(n, m) for n, m in metrics
                       if n.startswith(prefixes)] if prefixes else []
        lines: List[str] = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for s in m._snapshot():
                key = _label_key(s["labels"])
                if m.kind == "histogram":
                    for le, c in s["buckets"].items():
                        le_label = 'le="%s"' % le
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels(key, le_label)} {c}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} "
                                 f"{s['sum']}")
                    lines.append(f"{name}_count{_fmt_labels(key)} "
                                 f"{s['count']}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(key)} {s['value']}")
        return "\n".join(lines) + ("\n" if lines else "")


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str, help: str = "", always: bool = False) -> Counter:
    return _REGISTRY.counter(name, help, always)


def gauge(name: str, help: str = "", always: bool = False) -> Gauge:
    return _REGISTRY.gauge(name, help, always)


def histogram(name: str, help: str = "", always: bool = False,
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, help, always, buckets=buckets)


# Pick up an env-set FLAGS_enable_metrics (define_flag parses env
# overrides without firing on_change; later set_flags calls keep this in
# sync through the hook in flags.py).
from ..flags import GLOBAL_FLAGS as _GF  # noqa: E402

# ptlint: disable=flag-freeze -- deliberate: seeds _ENABLED from the env once; flags.py's on_change hook keeps it in sync afterwards
_ENABLED = bool(_GF.get("enable_metrics"))
