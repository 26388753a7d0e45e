"""Capture tracker for the captured steps.

Counterpart of ``paddle_tpu.observability.recompile``. The JAX tracker
wraps the jit boundaries (``jit.StaticFunction``, ``TrainStep``,
``EvalStep``): every new abstract input signature is a trace (an XLA
recompile), every other call a cache hit. The port has no ``jit`` to
wrap; its counterpart of a trace is a CUDA-graph capture of
``static.TrainStep`` / ``EvalStep`` (one per input signature, the step's
``captures`` and ``capture_ms``), and its counterpart of a cache hit is
a replay. They feed the same series:

- ``jit_traces_total{fn=}`` (always on: it costs nothing per step) and
  a ``recompile`` flight event per capture, with the signature;
- ``jit_compile_seconds{fn=}``, the host time of the call that captured
  (the eager warm-up plus the capture), and ``jit_cache_hits_total{fn=}``
  per replay, both gated on FLAGS_enable_metrics;
- a warning, ONCE per function, when it has been captured for at least
  FLAGS_recompile_warn_threshold distinct signatures (a capture storm:
  unpadded or unbucketed input shapes).

The JAX tracker's program-card harvest (``xprof``) comes with the second
part of the observability port.
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Dict, List, Optional

import torch

from ..flags import GLOBAL_FLAGS
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["RecompileTracker", "FunctionRecord", "tracker",
           "signature_text"]


def signature_text(tree) -> str:
    """Stable string of every tensor leaf's (dtype, shape), in the JAX
    tracker's form (``float32[8, 512]``); other leaves by type name."""
    leaves: List[str] = []

    def walk(x) -> None:
        if isinstance(x, torch.Tensor):
            leaves.append(f"{str(x.dtype).replace('torch.', '')}"
                          f"{list(x.shape)}")
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif x is not None:
            leaves.append(repr(type(x).__name__))

    walk(tree)
    return "(" + ",".join(leaves) + ")"


class FunctionRecord:
    """Per-function capture/replay accounting."""

    def __init__(self, name: str, lock: threading.Lock) -> None:
        self.name = name
        self._lock = lock
        self.traces = 0
        self.calls = 0
        self.hits = 0
        self.signatures: List[str] = []
        self.compile_times_s: List[float] = []
        self._warned = False

    def note_trace(self, sig: str) -> None:
        """One capture of signature ``sig`` (always counted)."""
        threshold = None
        with self._lock:
            self.traces += 1
            if sig not in self.signatures:
                self.signatures.append(sig)
            n_sigs = len(self.signatures)
            if not self._warned:
                threshold = int(GLOBAL_FLAGS.get("recompile_warn_threshold"))
                if threshold and n_sigs >= threshold:
                    self._warned = True
                else:
                    threshold = None
        _metrics.counter(
            "jit_traces_total",
            "jit traces (recompilations) per function", always=True
        ).inc(fn=self.name)
        _flight.record("recompile", fn=self.name, signature=sig[:200],
                       distinct_signatures=n_sigs)
        if threshold:
            warnings.warn(
                f"recompilation storm: '{self.name}' has been traced "
                f"for {n_sigs} distinct input signatures (threshold "
                f"{threshold}); latest {sig[:200]} — pad or bucket "
                f"input shapes (FLAGS_recompile_warn_threshold)",
                RuntimeWarning, stacklevel=3)

    def on_call(self, dt_s: float, traced: bool) -> None:
        """A finished call: ``traced`` when it captured (``dt_s`` its host
        time), else a replay. Callers gate this on metrics being on."""
        with self._lock:
            self.calls += 1
            if traced:
                self.compile_times_s.append(dt_s)
            else:
                self.hits += 1
        if traced:
            _metrics.histogram(
                "jit_compile_seconds",
                "wall time of dispatch calls that traced",
                buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 15, 60, 300)
            ).observe(dt_s, fn=self.name)
        else:
            _metrics.counter("jit_cache_hits_total",
                             "jit dispatches served from cache"
                             ).inc(fn=self.name)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"name": self.name, "traces": self.traces,
                    "calls": self.calls, "hits": self.hits,
                    "signatures": list(self.signatures),
                    "compile_times_s": list(self.compile_times_s)}


class RecompileTracker:
    """Registry of FunctionRecords, keyed by display name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._fns: Dict[str, FunctionRecord] = {}

    def function(self, name: str) -> FunctionRecord:
        with self._lock:
            rec = self._fns.get(name)
            if rec is None:
                rec = FunctionRecord(name, threading.Lock())
                self._fns[name] = rec
            return rec

    def get(self, name: str) -> Optional[FunctionRecord]:
        with self._lock:
            return self._fns.get(name)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            fns = list(self._fns.values())
        return {r.name: r.stats() for r in fns}

    def reset(self) -> None:
        with self._lock:
            self._fns.clear()


_TRACKER = RecompileTracker()


def tracker() -> RecompileTracker:
    return _TRACKER
