"""Host span tracer with Chrome ``traceEvents`` export.

Counterpart of ``paddle_tpu.observability.tracer``. Spans are nestable
(a per-thread stack tracks depth) and thread-aware (tid = real thread
id); every span also opens ``torch.profiler.record_function(name)``
(where the JAX tracer opens a ``jax.profiler.TraceAnnotation``), so
under ``torch.profiler`` the host spans land on the same timeline as
the CUDA kernels they launch.

Export is the Chrome ``traceEvents`` JSON array-of-events form, the
JAX tracer's schema — loadable in Perfetto (ui.perfetto.dev),
chrome://tracing and TensorBoard's trace viewer. Timestamps are
microseconds.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from ..flags import GLOBAL_FLAGS
from . import metrics as _metrics

__all__ = ["SpanTracer", "tracer", "span", "export_chrome_trace"]

# Cap on retained events: a runaway loop with tracing left on must not
# grow host memory without bound; drops are counted and reported.
MAX_EVENTS = 200_000

_PID = os.getpid()


class SpanTracer:
    """Collects host spans as chrome trace events."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._tls = threading.local()
        # perf_counter gives monotonic sub-µs deltas; anchor it once so
        # absolute ts values are comparable across threads.
        self._epoch = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, force: bool = False,
             **args) -> Iterator[None]:
        """Record a nested host span; no-op unless metrics are enabled
        (or ``force=True`` — the explicit user-API path)."""
        if not (force or _metrics.enabled()):
            yield
            return
        self._tls.depth = self._depth() + 1
        t0 = self._now_us()
        ann = torch.profiler.record_function(name)
        ann.__enter__()
        try:
            yield
        finally:
            ann.__exit__(None, None, None)
            dur = self._now_us() - t0
            self._tls.depth -= 1
            ev = {"name": name, "ph": "X", "ts": t0, "dur": dur,
                  "pid": _PID, "tid": threading.get_ident(), "cat": "host"}
            if args:
                ev["args"] = {k: str(v) for k, v in args.items()}
            with self._lock:
                if len(self._events) < MAX_EVENTS:
                    self._events.append(ev)
                else:
                    self._dropped += 1

    def instant(self, name: str, force: bool = False, **args) -> None:
        """Zero-duration marker event."""
        if not (force or _metrics.enabled()):
            return
        ev = {"name": name, "ph": "i", "ts": self._now_us(), "pid": _PID,
              "tid": threading.get_ident(), "s": "t", "cat": "host"}
        if args:
            ev["args"] = {k: str(v) for k, v in args.items()}
        with self._lock:
            if len(self._events) < MAX_EVENTS:
                self._events.append(ev)
            else:
                self._dropped += 1

    # -- views -------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Aggregated per-span table in SECONDS — the shape the old
        ``profiler.event_summary`` promised (calls/total/avg/max)."""
        agg: Dict[str, Dict[str, float]] = {}
        for e in self.events():
            if e.get("ph") != "X":
                continue
            a = agg.setdefault(e["name"], {"calls": 0, "total_s": 0.0,
                                           "max_s": 0.0})
            dur_s = e["dur"] / 1e6
            a["calls"] += 1
            a["total_s"] += dur_s
            a["max_s"] = max(a["max_s"], dur_s)
        for a in agg.values():
            a["avg_s"] = a["total_s"] / max(a["calls"], 1)
        return agg

    def chrome_trace(self) -> Dict[str, Any]:
        """Full trace dict: metadata events + recorded spans."""
        events = self.events()
        tids = sorted({e["tid"] for e in events})
        meta: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "args": {"name": "paddle_tpu_torch host"}}]
        for i, tid in enumerate(tids):
            meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                         "tid": tid, "args": {"name": f"host thread {i}"}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "metadata": {"dropped_events": self.dropped()}}

    def export(self, path: Optional[str] = None) -> str:
        """Write the chrome trace JSON; returns the path written.

        ``path`` may be a directory (the file becomes
        ``host_trace.json`` inside it) or a file path. Defaults to
        FLAGS_trace_dir, then ``pt_trace`` in the temporary directory.
        """
        if path is None:
            path = GLOBAL_FLAGS.get("trace_dir") or os.path.join(
                tempfile.gettempdir(), "pt_trace")
        if not path.endswith(".json"):
            os.makedirs(path, exist_ok=True)
            path = os.path.join(path, "host_trace.json")
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_TRACER = SpanTracer()


def tracer() -> SpanTracer:
    return _TRACER


def span(name: str, force: bool = False, **args):
    """Module-level shortcut: ``with span("train/step"): ...``"""
    return _TRACER.span(name, force=force, **args)


def export_chrome_trace(path: Optional[str] = None) -> str:
    return _TRACER.export(path)
