"""Framework-wide telemetry.

Counterpart of ``paddle_tpu.observability``, the same module paths,
metric names, label sets and record layouts, so dashboards and drills
written for the JAX package read the port unchanged:

- :mod:`metrics`   — typed counters/gauges/histograms with labeled
  series, Prometheus text exposition + JSON snapshot.
- :mod:`tracer`    — nestable, thread-aware host spans exported as
  Chrome ``traceEvents`` JSON, each span also a
  ``torch.profiler.record_function`` so host spans and CUDA kernels
  share one timeline.
- :mod:`recompile` — capture (the port's counterpart of a jit trace)
  and replay accounting of the captured steps, storm warnings.
- :mod:`flight`    — the crash flight recorder.
- :mod:`anomaly`   — the NaN/Inf and spike sentinel on step scalars.
- :mod:`reqtrace`, :mod:`seqtrace`, :mod:`stepprof` — the serving
  plane's request spans, sequence timelines and engine step records.

Everything instrument-shaped is gated on ``FLAGS_enable_metrics``: off
(the default) is one cached boolean test on every hot path.

Not ported yet (the second part of the observability port): the HTTP
exporter (``server.py``) and what only it and ``hapi`` read
(``stacks``, ``slo``, ``tsdb``, ``goodput``, ``fleet``, ``xprof``,
``trace_agg``).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import torch

from ..flags import GLOBAL_FLAGS
from . import (anomaly, flight, metrics, recompile, reqtrace, rotation,
               seqtrace, stepprof, tracer)
from .anomaly import sentinel as anomaly_sentinel
from .flight import recorder as flight_recorder
from .metrics import (counter, enabled, gauge, histogram, registry,
                      set_enabled)
from .recompile import tracker as recompile_tracker
from .tracer import export_chrome_trace, span
from .tracer import tracer as get_tracer

__all__ = ["metrics", "tracer", "recompile", "anomaly", "flight",
           "rotation", "reqtrace", "seqtrace", "stepprof",
           "counter", "gauge", "histogram", "registry", "enabled",
           "set_enabled", "span", "export_chrome_trace", "get_tracer",
           "recompile_tracker", "anomaly_sentinel", "native_stats",
           "flight_recorder", "observe_traced", "device_memory_stats",
           "export_all", "reset_all"]

# bytes_in_use plus the extra allocator fields ``full=True`` reports
_FULL_MEM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_stats(include_unavailable: bool = False,
                        full: bool = False) -> Dict[str, Any]:
    """Per-device allocator stats of the CUDA caching allocator.

    Default: ``{device: bytes_in_use}``. With ``full=True`` each device
    maps to ``{bytes_in_use, peak_bytes_in_use, bytes_limit}``
    (``torch.cuda.memory_stats``' ``allocated_bytes.all.current`` and
    ``.peak``, and the card's total memory from ``mem_get_info``). The
    CPU has no allocator stats: with no card the result is empty (JAX
    skips its CPU devices likewise), and ``include_unavailable=True``
    reports ``{"cpu": 0}`` (zeros with ``full``) so dashboards keep the
    series."""
    out: Dict[str, Any] = {}
    if not torch.cuda.is_available():
        if include_unavailable:
            out["cpu"] = {k: 0 for k in _FULL_MEM_KEYS} if full else 0
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        used = int(ms.get("allocated_bytes.all.current", 0))
        name = f"cuda:{i}"
        if full:
            _free, total = torch.cuda.mem_get_info(i)
            out[name] = {"bytes_in_use": used,
                         "peak_bytes_in_use":
                             int(ms.get("allocated_bytes.all.peak", 0)),
                         "bytes_limit": int(total)}
        else:
            out[name] = used
    return out


def native_stats() -> Dict[str, int]:
    """Snapshot of the native stat registry (csrc/monitor.cc) of the
    port's own ``native`` library. Returns {} when that library has not
    been loaded (never triggers a build)."""
    from .. import native as _native
    if not _native.loaded():
        return {}
    return _native.stat_dump()


def observe_traced(name: str, value: Any, kind: str = "gauge") -> None:
    """Record a device scalar into a host metric.

    The JAX version inserts a ``jax.debug.callback`` into a traced
    program. A CUDA graph runs no host code at replay, so here the value
    is recorded eagerly (a gauge keeps the tensor and reads it only at
    exposition; a counter reads it now), and a call made while the
    current stream is capturing raises: a step feeds such values out as
    outputs (``TrainStep``'s drain) instead."""
    if not metrics.enabled():
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"observe_traced({name!r}) inside a CUDA graph capture: the "
            f"graph would record nothing on the host; return the value "
            f"from the step and record it after the replay")
    if kind == "counter":
        metrics.counter(name).inc(float(value))
    else:
        metrics.gauge(name).set(value)


def export_all(path: Optional[str] = None) -> Dict[str, str]:
    """Write the host chrome trace + snapshots under ``path`` (default
    FLAGS_trace_dir, then ``pt_trace`` in the temporary directory);
    returns the written paths. Emits the JSON snapshot
    (``metrics.json``: metrics + capture records + native stats) and the
    Prometheus text exposition (``metrics.prom``)."""
    if path is None:
        path = GLOBAL_FLAGS.get("trace_dir") or os.path.join(
            tempfile.gettempdir(), "pt_trace")
    os.makedirs(path, exist_ok=True)
    out = {"trace": get_tracer().export(path)}
    snap = {"metrics": registry().snapshot(),
            "recompile": recompile_tracker().snapshot(),
            "native_stats": native_stats()}
    mpath = os.path.join(path, "metrics.json")
    with open(mpath, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True, default=str)
    out["metrics"] = mpath
    ppath = os.path.join(path, "metrics.prom")
    with open(ppath, "w") as f:
        f.write(registry().prometheus_text())
    out["prometheus"] = ppath
    return out


def reset_all() -> None:
    """Clear metrics, spans, capture records, anomaly state, the flight
    buffer and the request-span / seq-timeline / step-record rings
    (tests / new runs)."""
    registry().reset()
    get_tracer().reset()
    recompile_tracker().reset()
    anomaly_sentinel().reset()
    flight_recorder().reset()
    reqtrace.ring().reset()
    seqtrace.ring().reset()
    stepprof.ring().reset()
