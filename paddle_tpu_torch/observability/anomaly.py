"""Anomaly sentinel: NaN/Inf and spike detection on step scalars.

Counterpart of ``paddle_tpu.observability.anomaly``; the sentinel is the
same. Its feed differs: the JAX step streams each watched scalar (loss,
gradient global norm) to the host through a ``jax.debug.callback`` (or,
under a compile cache, as step outputs drained on the host). A CUDA
graph runs no host code at replay, so the port's ``TrainStep`` always
takes the second route: the scalars are step outputs, copied to pinned
host memory behind a CUDA event, and ``TrainStep.flush_signals`` hands
them to :meth:`AnomalySentinel.observe` once the event has completed —
no blocking sync, nothing at all while FLAGS_enable_metrics is off.

Host side, each watched series keeps an EWMA; a sample is an anomaly
when it is non-finite, or exceeds ``FLAGS_anomaly_spike_factor`` times
the EWMA after a short warmup. Anomalies increment ``anomalies_total
{kind=,series=}``, enter the crash flight recorder, and append one
JSON record per event to ``events.jsonl`` under FLAGS_trace_dir
(structured, tail-able — the audit analogue of the reference's nan-inf
printouts). The file rolls to ``events.jsonl.1`` at 16 MB and only the
two newest generations are kept (rotation.append_jsonl), so a
weeks-long run of a spiky job cannot fill the disk.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, Optional

from ..flags import GLOBAL_FLAGS
from . import flight as _flight
from . import metrics as _metrics
from . import rotation as _rotation

__all__ = ["AnomalySentinel", "sentinel", "DivergenceWatchdog"]

_WARMUP_SAMPLES = 5
_EWMA_ALPHA = 0.1


class AnomalySentinel:
    """Per-series EWMA watcher with a JSONL event log."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: Dict[str, Dict[str, float]] = {}
        self._listeners: list = []

    # -- listeners ---------------------------------------------------------

    def add_listener(self, fn) -> None:
        """Register ``fn(series, value, kind)`` called on EVERY
        observed sample (kind None for clean ones) — the divergence
        watchdog's feed. Listener exceptions are swallowed: a broken
        consumer must not poison the probe stream."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- host side ---------------------------------------------------------

    def observe(self, series: str, value: float) -> Optional[str]:
        """Feed one host-side sample; returns the anomaly kind recorded
        ("nan" | "spike") or None. ``TrainStep``'s drain calls it; usable
        directly for host-driven series (tests, custom loops)."""
        kind = None
        ewma = None
        with self._lock:
            st = self._series.setdefault(series, {"ewma": 0.0, "n": 0})
            if not math.isfinite(value):
                kind = "nan"
            else:
                ewma = st["ewma"]
                factor = self._spike_factor()
                if (factor > 0 and st["n"] >= _WARMUP_SAMPLES
                        and abs(value) > factor * max(abs(ewma), 1e-12)):
                    kind = "spike"
                st["ewma"] = (value if st["n"] == 0 else
                              (1 - _EWMA_ALPHA) * ewma
                              + _EWMA_ALPHA * value)
                st["n"] += 1
        if kind is not None:
            self._record(kind, series, value, ewma)
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(series, value, kind)
            except Exception:  # noqa: BLE001 — see add_listener
                pass
        return kind

    @staticmethod
    def _spike_factor() -> float:
        return float(GLOBAL_FLAGS.get("anomaly_spike_factor"))

    def _record(self, kind: str, series: str, value: float,
                ewma: Optional[float]) -> None:
        _metrics.counter(
            "anomalies_total",
            "NaN/Inf and spike events seen by the anomaly sentinel"
        ).inc(kind=kind, series=series)
        safe_value = value if math.isfinite(value) else str(value)
        _flight.record("anomaly", anomaly=kind, series=series,
                       value=safe_value)
        trace_dir = GLOBAL_FLAGS.get("trace_dir")
        if not trace_dir:
            return
        rec = {"ts_unix": time.time(), "kind": kind, "series": series,
               "value": safe_value}
        if ewma is not None:
            rec["ewma"] = ewma
        with self._lock:
            _rotation.append_jsonl(os.path.join(trace_dir,
                                                "events.jsonl"), [rec])

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


class DivergenceWatchdog:
    """Trips when a watched series produces ``streak`` CONSECUTIVE
    anomalous samples (NaN/Inf, or an EWMA spike per
    FLAGS_anomaly_spike_factor) — the divergence detector behind the
    JAX ``hapi.Model.fit``'s checkpoint rollback. Feeds off the
    sentinel's listener stream, so it sees exactly what the step's probes
    see (never a host sync). A clean sample resets the streak."""

    def __init__(self, series=("loss",),
                 streak: Optional[int] = None) -> None:
        self.series = set(series)
        self._need = int(streak) if streak else self._streak_flag()
        self._lock = threading.Lock()
        self._streak = 0
        self._tripped = False

    @staticmethod
    def _streak_flag() -> int:
        return max(1, int(GLOBAL_FLAGS.get("divergence_streak")))

    def sample(self, series: str, value: float,
               kind: Optional[str]) -> None:
        """Sentinel-listener entry point."""
        if series not in self.series:
            return
        with self._lock:
            if kind is None:
                self._streak = 0
            else:
                self._streak += 1
                if self._streak >= self._need:
                    self._tripped = True

    def attach(self, sent: "AnomalySentinel") -> "DivergenceWatchdog":
        sent.add_listener(self.sample)
        return self

    def detach(self, sent: "AnomalySentinel") -> None:
        sent.remove_listener(self.sample)

    def tripped(self) -> bool:
        return self._tripped

    def reset(self) -> None:
        with self._lock:
            self._streak = 0
            self._tripped = False


_SENTINEL = AnomalySentinel()


def sentinel() -> AnomalySentinel:
    return _SENTINEL

