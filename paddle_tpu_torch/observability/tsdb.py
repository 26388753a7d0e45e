"""Bounded in-process time-series rings over the metrics registry.

Counterpart of ``paddle_tpu.observability.tsdb``: the same sampler
thread (``pt-tsdb-sampler``), ring layout, windowed reads and gauges.

The registry (observability/metrics.py) holds lifetime values — a
counter is one ever-growing number, a histogram one cumulative bucket
vector. Judging an SLO needs *windows*: "how many requests failed in
the last five minutes", "what was p99 TTFT over the last hour". This
module makes those questions answerable locally, without an external
Prometheus: a sampler thread snapshots a *watched* subset of the
registry every ``FLAGS_tsdb_interval_s`` seconds into per-series
bounded deques (``FLAGS_tsdb_ring`` samples each, rotation eviction
like the seqtrace/stepprof rings), and windowed ``increase()`` /
``rate()`` / ``quantile_over_window()`` reads diff the newest sample
against a baseline at the window's left edge.

Sample stamps are ``time.monotonic()`` — every window computation
subtracts stamps, so they must come from the monotonic clock (ptlint
clock-hygiene). Payloads by instrument kind:

- counter → one float, summed across label sets (an SLO burns on the
  metric as a whole; per-label series would explode the ring),
- gauge   → one float, summed across label sets,
- histogram → the cumulative bucket-count vector summed across label
  sets, plus lifetime ``count``/``sum``; the declared boundaries ride
  along once per series.

Counter resets (process restart, registry.reset() in tests) make a
newer sample smaller than an older one; ``increase()`` clamps that to
the newer value (the counter restarted from zero — everything it now
holds happened after the reset), per-bucket for histograms.

Only *watched* names are sampled — the SLO engine (observability/slo.py)
watches whatever its specs reference, and anything else can be added
with :func:`watch`. That keeps the memory bound explicit:
``len(watched) × FLAGS_tsdb_ring`` samples, published as the
``tsdb_ring_entries`` / ``tsdb_ring_series`` gauges.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..flags import GLOBAL_FLAGS
from . import metrics as _metrics

_log = logging.getLogger("paddle_tpu_torch.observability")

__all__ = ["TsdbRing", "ring", "watch", "sample_once", "start", "stop"]

def _capacity() -> int:
    return max(8, int(GLOBAL_FLAGS.get("tsdb_ring")))


def _interval_s() -> float:
    return max(0.01, float(GLOBAL_FLAGS.get("tsdb_interval_s")))


def _sum_series(snap: List[Dict[str, Any]]) -> float:
    return float(sum(s["value"] for s in snap))


class TsdbRing:
    """Per-metric bounded sample deques + the sampler thread."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._capacity = capacity or _capacity()
        # name -> {"kind", "bounds", "samples": deque}  # guarded-by: self._lock
        self._series: Dict[str, Dict[str, Any]] = {}
        self._watched: set = set()  # guarded-by: self._lock
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- watch set ----------------------------------------------------

    def watch(self, *names: str) -> None:
        """Add metric names to the sampled set (idempotent). Unknown
        names are fine — sampling skips them until they register."""
        with self._lock:
            self._watched.update(names)

    def watched(self) -> List[str]:
        with self._lock:
            return sorted(self._watched)

    # -- sampling -----------------------------------------------------

    def sample_once(self, now: Optional[float] = None) -> int:
        """Snapshot every watched metric that exists in the registry;
        returns how many series were stamped. ``now`` is injectable
        for tests and must be a ``time.monotonic()``-domain stamp."""
        t = time.monotonic() if now is None else float(now)
        reg = _metrics.registry()
        with self._lock:
            names = sorted(self._watched)
        stamped = 0
        for name in names:
            m = reg.get(name)
            if m is None:
                continue
            if m.kind == "histogram":
                snap = m._snapshot()
                counts = [0] * len(m.buckets)
                count, total = 0, 0.0
                for s in snap:
                    for i, b in enumerate(m.buckets):
                        counts[i] += s["buckets"].get(str(b), 0)
                    count += s["count"]
                    total += s["sum"]
                payload = {"counts": tuple(counts), "count": count,
                           "sum": total}
            else:
                payload = _sum_series(m._snapshot())
            with self._lock:
                ser = self._series.get(name)
                if ser is None:
                    ser = {"kind": m.kind,
                           "bounds": (tuple(m.buckets)
                                      if m.kind == "histogram" else None),
                           "samples": deque(maxlen=self._capacity)}
                    self._series[name] = ser
                ser["samples"].append((t, payload))
            stamped += 1
        self._publish_sizes()
        return stamped

    def _publish_sizes(self) -> None:
        with self._lock:
            n_series = len(self._series)
            n_samples = sum(len(s["samples"])
                            for s in self._series.values())
        _metrics.gauge(
            "tsdb_ring_entries",
            "samples held across all tsdb series (bounded by "
            "watched-series count x FLAGS_tsdb_ring)").set(
                float(n_samples))
        _metrics.gauge(
            "tsdb_ring_series",
            "metric series held by the tsdb ring (the watched set "
            "that actually exists in the registry)").set(
                float(n_series))

    # -- sampler thread -----------------------------------------------

    def start(self) -> None:
        """Start the sampler daemon thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="pt-tsdb-sampler", daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        with self._lock:
            th = self._thread
            self._thread = None
        self._stop.set()
        if th is not None and th.is_alive():
            th.join(timeout=timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample_once()
                from . import slo as _slo
                _slo.engine().evaluate()
            # the sampler must outlive any registry/SLO hiccup: the
            # next tick retries
            except Exception:  # noqa: BLE001
                _log.exception("tsdb sampler tick failed")
            self._stop.wait(_interval_s())

    # -- windowed reads -----------------------------------------------

    def _window_pair(self, name: str, window_s: float,
                     now: Optional[float]) -> Optional[Tuple[Any, Any, Dict[str, Any]]]:
        """(baseline_payload, newest_payload, series) for the window
        ending at ``now``; baseline is the last sample at or before the
        window's left edge, else the oldest sample inside it."""
        t_now = time.monotonic() if now is None else float(now)
        left = t_now - float(window_s)
        with self._lock:
            ser = self._series.get(name)
            if ser is None or not ser["samples"]:
                return None
            samples = list(ser["samples"])
            info = {"kind": ser["kind"], "bounds": ser["bounds"]}
        newest = samples[-1]
        baseline = None
        for t, payload in samples:
            if t <= left:
                baseline = (t, payload)
            else:
                break
        if baseline is None:
            baseline = samples[0]
        return baseline[1], newest[1], info

    def increase(self, name: str, window_s: float,
                 now: Optional[float] = None) -> float:
        """Windowed increase of a counter (or gauge delta); histogram
        series answer with their ``count`` increase. 0.0 when the
        series is unknown or has a single sample. Counter resets clamp
        to the newer value."""
        pair = self._window_pair(name, window_s, now)
        if pair is None:
            return 0.0
        base, newest, info = pair
        if info["kind"] == "histogram":
            b, n = base["count"], newest["count"]
        else:
            b, n = base, newest
        return float(n if n < b else n - b)

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None) -> float:
        """Per-second rate over the window (increase / window)."""
        w = max(1e-9, float(window_s))
        return self.increase(name, w, now) / w

    def hist_increase(self, name: str, window_s: float,
                      now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Windowed histogram delta: per-bucket cumulative-count
        increases plus ``count``/``sum`` increases, reset-clamped
        per bucket. None when the series is unknown or not a
        histogram."""
        pair = self._window_pair(name, window_s, now)
        if pair is None:
            return None
        base, newest, info = pair
        if info["kind"] != "histogram":
            return None
        counts = tuple(
            n if n < b else n - b
            for b, n in zip(base["counts"], newest["counts"]))
        count = (newest["count"] if newest["count"] < base["count"]
                 else newest["count"] - base["count"])
        total = (newest["sum"] if newest["count"] < base["count"]
                 else newest["sum"] - base["sum"])
        return {"bounds": info["bounds"], "counts": counts,
                "count": count, "sum": total}

    def quantile_over_window(self, name: str, q: float, window_s: float,
                             now: Optional[float] = None) -> float:
        """Bucket-interpolated quantile of a histogram's observations
        inside the window (metrics.quantile_from_buckets over the
        windowed bucket delta); ``nan`` when nothing landed there."""
        d = self.hist_increase(name, window_s, now)
        if d is None or d["count"] <= 0:
            return float("nan")
        bounds = list(d["bounds"]) + [float("inf")]
        counts = list(d["counts"]) + [d["count"]]
        return _metrics.quantile_from_buckets((bounds, counts), q)

    def value(self, name: str) -> float:
        """Newest sampled value (counter/gauge: the float; histogram:
        its lifetime count); ``nan`` when never sampled."""
        with self._lock:
            ser = self._series.get(name)
            if ser is None or not ser["samples"]:
                return float("nan")
            payload = ser["samples"][-1][1]
            kind = ser["kind"]
        if kind == "histogram":
            return float(payload["count"])
        return float(payload)

    # -- bookkeeping --------------------------------------------------

    @property
    def capacity(self) -> int:
        return self._capacity

    def resize(self, capacity: int) -> None:
        """Rebuild every series deque at the new capacity keeping the
        newest samples (FLAGS_tsdb_ring on_change hook)."""
        cap = max(8, int(capacity))
        with self._lock:
            self._capacity = cap
            for ser in self._series.values():
                ser["samples"] = deque(ser["samples"], maxlen=cap)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self._capacity,
                "series": len(self._series),
                "watched": len(self._watched),
                "samples": {name: len(ser["samples"])
                            for name, ser in self._series.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._watched.clear()


_RING = TsdbRing()


def ring() -> TsdbRing:
    return _RING


def watch(*names: str) -> None:
    _RING.watch(*names)


def sample_once(now: Optional[float] = None) -> int:
    return _RING.sample_once(now)


def start() -> None:
    _RING.start()


def stop() -> None:
    _RING.stop()
