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
- :mod:`server`    — the live HTTP exporter (``/metrics``, ``/healthz``,
  ``/varz``, ``/trace``, ``/goodput``, ``/alerts``, ``/slo``,
  ``/flight``, ``/requests``, ``/llm/*``, ``/stacks``, ``/fleet*``,
  ``/router``), and what it serves beside the core:
- :mod:`tsdb`, :mod:`slo` — windowed time-series rings over the registry
  and the multi-window burn-rate SLO alerts judged on them;
- :mod:`goodput`   — the exclusive wall-time ledger of a training run;
- :mod:`xprof`     — program cards (FLOPs and peak memory) per captured
  step signature;
- :mod:`stacks`    — the hang doctor (stack capture, sampling profiler,
  wedge monitor);
- :mod:`fleet`     — cross-host federation (push, merge, serve);
- :mod:`trace_agg` — chrome-trace roll-ups of host spans and CUDA
  kernels.

Everything instrument-shaped is gated on ``FLAGS_enable_metrics``: off
(the default) is one cached boolean test on every hot path.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import torch

from ..flags import GLOBAL_FLAGS
from . import (anomaly, fleet, flight, goodput, metrics, recompile,
               reqtrace, rotation, seqtrace, server, slo, stacks, stepprof,
               trace_agg, tracer, tsdb, xprof)
from .anomaly import sentinel as anomaly_sentinel
from .flight import recorder as flight_recorder
from .goodput import ledger as goodput_ledger
from .metrics import (counter, enabled, gauge, histogram, registry,
                      set_enabled)
from .recompile import tracker as recompile_tracker
from .tracer import export_chrome_trace, span
from .tracer import tracer as get_tracer
from .xprof import cards as program_cards

__all__ = ["metrics", "tracer", "recompile", "trace_agg", "xprof",
           "anomaly", "server", "goodput", "flight", "rotation",
           "fleet", "reqtrace", "seqtrace", "stepprof", "tsdb", "slo",
           "stacks",
           "counter", "gauge", "histogram", "registry", "enabled",
           "set_enabled", "span", "export_chrome_trace", "get_tracer",
           "recompile_tracker", "program_cards", "anomaly_sentinel",
           "native_stats", "goodput_ledger", "flight_recorder",
           "observe_traced", "device_memory_stats", "export_all",
           "reset_all"]

# bytes_in_use plus the extra allocator fields ``full=True`` reports
_FULL_MEM_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def device_memory_stats(include_unavailable: bool = False,
                        full: bool = False) -> Dict[str, Any]:
    """Per-device allocator stats of the CUDA caching allocator.

    Default: ``{device: bytes_in_use}``. With ``full=True`` each device
    maps to ``{bytes_in_use, peak_bytes_in_use, bytes_limit}``
    (``torch.cuda.memory_stats``' ``allocated_bytes.all.current`` and
    ``.peak``, and the card's total memory from its cached properties).
    Host-side reads only: the exporter calls this from its own thread,
    where a device query could invalidate another thread's CUDA-graph
    capture. The CPU has no allocator stats: with no card the result is
    empty (JAX skips its CPU devices likewise), and
    ``include_unavailable=True`` reports ``{"cpu": 0}`` (zeros with
    ``full``) so dashboards keep the series."""
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
            total = torch.cuda.get_device_properties(i).total_memory
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
    returns the written paths. Emits the JSON snapshot (``metrics.json``:
    metrics + capture records + program cards + goodput ledger + SLO
    alerts and tsdb ring stats + native stats) and the Prometheus text
    exposition (``metrics.prom``, the exporter's ``/metrics`` page)."""
    if path is None:
        path = GLOBAL_FLAGS.get("trace_dir") or os.path.join(
            tempfile.gettempdir(), "pt_trace")
    os.makedirs(path, exist_ok=True)
    out = {"trace": get_tracer().export(path)}
    goodput_ledger().publish()
    snap = {"metrics": registry().snapshot(),
            "recompile": recompile_tracker().snapshot(),
            "programs": program_cards().snapshot(),
            "goodput": goodput_ledger().snapshot(),
            "alerts": slo.engine().alerts_view(),
            "tsdb": tsdb.ring().stats(),
            "native_stats": native_stats()}
    mpath = os.path.join(path, "metrics.json")
    with open(mpath, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True, default=str)
    out["metrics"] = mpath
    ppath = os.path.join(path, "metrics.prom")
    with open(ppath, "w") as f:
        f.write(server.metrics_text())
    out["prometheus"] = ppath
    return out


def reset_all() -> None:
    """Clear metrics, spans, capture records, program cards, anomaly
    state, the goodput ledger, the flight buffer, the request-span /
    seq-timeline / step-record rings, the fleet aggregator store, the
    tsdb sample ring (stopping its sampler thread), the SLO alert engine
    and the hang-doctor plane (stack sampler + monitor stopped, profile
    cleared) (tests / new runs)."""
    registry().reset()
    get_tracer().reset()
    recompile_tracker().reset()
    program_cards().reset()
    anomaly_sentinel().reset()
    goodput_ledger().reset()
    flight_recorder().reset()
    reqtrace.ring().reset()
    seqtrace.ring().reset()
    stepprof.ring().reset()
    fleet.aggregator().reset()
    tsdb.stop()
    tsdb.ring().reset()
    slo.engine().reset()
    stacks.reset()
