"""Profiling compat shim over :mod:`paddle_tpu_torch.observability`.

Counterpart of ``paddle_tpu.profiler``, the same surface:

- ``start_profiler``/``stop_profiler``/``profiler`` — a device capture,
  here ``torch.profiler`` (CPU and CUDA activities) in place of JAX's
  xplane trace; ``stop_profiler`` writes its chrome trace
  (``pt_profile.trace.json``) under the directory and returns it, which
  ``observability.trace_agg`` rolls up.
- ``RecordEvent`` — a host span (also a ``record_function`` range on the
  profiler's timeline); records regardless of FLAGS_enable_metrics (an
  explicit call is its own opt-in).
- ``stats``/``stat_add``/``StatRegistry`` — views over the metrics
  registry; names share the registry namespace.
- ``event_summary``/``get_host_events``/``reset_host_events`` — served
  from the span tracer.
- ``benchmark_sync`` (``torch.cuda.synchronize`` for tensors on the
  card), ``device_memory_stats`` and ``StepTimer``.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from . import observability as _obs
from .flags import GLOBAL_FLAGS
from .observability import device_memory_stats  # noqa: F401  (public)

__all__ = ["start_profiler", "stop_profiler", "profiler", "RecordEvent",
           "get_host_events", "reset_host_events", "event_summary",
           "StatRegistry", "stats", "stat_add", "benchmark_sync",
           "StepTimer", "device_memory_stats"]

TRACE_FILE = "pt_profile.trace.json"


class _ProfilerState:
    def __init__(self) -> None:
        self.prof: Optional[torch.profiler.profile] = None
        self.log_dir: Optional[str] = None


_state = _ProfilerState()


def start_profiler(log_dir: Optional[str] = None) -> None:
    """Starts a ``torch.profiler`` capture of the host and (with a card)
    the CUDA kernels; FLAGS_profile_dir, then ``pt_prof`` in the
    temporary directory, when ``log_dir`` is None."""
    log_dir = log_dir or GLOBAL_FLAGS.get("profile_dir") or os.path.join(
        tempfile.gettempdir(), "pt_prof")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _state.prof = prof
    _state.log_dir = log_dir


def stop_profiler() -> Optional[str]:
    """Stops the capture, writes its chrome trace under the directory
    and returns the directory."""
    prof, _state.prof = _state.prof, None
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(_state.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(_state.log_dir, TRACE_FILE))
    return _state.log_dir


@contextlib.contextmanager
def profiler(log_dir: Optional[str] = None):
    """Context manager form of start/stop."""
    start_profiler(log_dir)
    try:
        yield
    finally:
        stop_profiler()


class RecordEvent:
    """Host-side span that also annotates the device trace."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._cm = None

    def __enter__(self) -> "RecordEvent":
        self._cm = _obs.span(self.name, force=True)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._cm.__exit__(*exc)


def get_host_events() -> List[Dict[str, Any]]:
    """Old event format: name / dur_s / ts (seconds)."""
    return [{"name": e["name"], "dur_s": e["dur"] / 1e6,
             "ts": e["ts"] / 1e6}
            for e in _obs.get_tracer().events() if e.get("ph") == "X"]


def reset_host_events() -> None:
    _obs.get_tracer().reset()


def event_summary() -> Dict[str, Dict[str, float]]:
    """Aggregated calls/total/avg/max table of the host spans."""
    return _obs.get_tracer().summary()


class StatRegistry:
    """A view over the observability metrics registry; add/get/set keep
    their int semantics and the counters they create are always-on
    (explicit user API)."""

    def __init__(self) -> None:
        self._names: Dict[str, bool] = {}

    def _c(self, name: str):
        self._names[name] = True
        return _obs.counter(name, always=True)

    def add(self, name: str, value: int = 1) -> None:
        self._c(name).inc(value)

    def get(self, name: str) -> int:
        return int(self._c(name).value())

    def set(self, name: str, value: int) -> None:
        self._c(name).set_total(value)

    def snapshot(self) -> Dict[str, int]:
        return {n: self.get(n) for n in self._names}


stats = StatRegistry()


def stat_add(name: str, value: int = 1) -> None:
    stats.add(name, value)


def _on_card(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_on_card(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_card(v) for v in tree)
    return False


def benchmark_sync(tree) -> Any:
    """Block until the card has finished the work behind ``tree``
    (``torch.cuda.synchronize`` when any tensor in it is on the card);
    returns ``tree``."""
    if _on_card(tree):
        torch.cuda.synchronize()
    return tree


class StepTimer:
    """Per-step timing hook with throughput accounting."""

    def __init__(self, items_per_step: int = 0) -> None:
        self.items_per_step = items_per_step
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if self._t0 is None:
            # stop() without start() would time against "now" and
            # record a ~0 sample that skews throughput
            return 0.0
        if GLOBAL_FLAGS.get("benchmark") and result is not None:
            benchmark_sync(result)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.times.append(dt)
        return dt

    def throughput(self, skip_first: int = 1) -> float:
        # drop warm-up samples, and never fall back to the skipped
        # (capture-inflated) sample when it is the only one
        ts = self.times[skip_first:]
        if not ts:
            return 0.0
        return self.items_per_step * len(ts) / sum(ts)
