"""Engine step profiler: the /llm/steps ring + live in-flight step.

Counterpart of ``paddle_tpu.observability.stepprof``, the same records.

Every ``LLMEngine.step()`` emits one step record — batch composition
by phase (prefilling / decoding / verifying counts), per-phase wall
durations (admit / prefill / decode / spec_verify / sample / scatter),
a KV-pool snapshot (used / free / shared blocks), prefix-hit and
speculative accept deltas, emitted token count, and the stall-watchdog
verdict — into a bounded deque (``FLAGS_llm_step_ring``,
rotation-style eviction; the JAX package serves it at ``/llm/steps``).
Recording a step also observes the
``llm_step_phase_ms{phase=}`` histograms (LATENCY_MS_BUCKETS, so the
fleet plane merges them bucket-wise like every latency series).

The LIVE half: ``step_begin``/``set_phase`` track the step that is
executing RIGHT NOW (begin stamps + current phase), so a wedged step is
diagnosable from :meth:`StepRecordRing.live` — which engine is stuck
and in which phase — instead of only being counted by ``health()``
after the fact. ``age_s`` is computed from the monotonic begin stamp;
``begin_unix`` is display-only and never subtracted.

Durations come from ``perf_counter``/``monotonic``; ``sample`` and
``scatter`` are sub-segments measured inside the prefill / decode /
spec_verify phases (they overlap those buckets, deliberately: an
attribution uses only the top-level phases). Keyed by an opaque
per-engine token (``id(engine)``), so several engines in one process
keep separate live entries.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..flags import GLOBAL_FLAGS
from . import metrics as _metrics

__all__ = ["StepRecordRing", "ring", "PHASES"]

# the per-phase duration buckets a step record carries (sample and
# scatter are sub-segments of the phases before them)
PHASES = ("admit", "prefill", "decode", "spec_verify", "sample",
          "scatter")


def _capacity() -> int:
    return max(8, int(GLOBAL_FLAGS.get("llm_step_ring")))


class StepRecordRing:
    """Bounded ring of engine step records + live in-flight steps."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        # finished step records, oldest first  # guarded-by: self._lock
        self._buf: deque = deque(maxlen=capacity or _capacity())
        # engine key -> live step state        # guarded-by: self._lock
        self._live: Dict[int, Dict[str, Any]] = {}

    # -- live in-flight step ------------------------------------------

    def step_begin(self, key: int, step: int,
                   begin_unix: float) -> None:
        """Open the live entry for an engine's in-flight step (no-op
        while metrics are off). ``begin_unix`` is display-only."""
        if not _metrics.enabled():
            return
        with self._lock:
            self._live[key] = {"engine": int(key) & 0xFFFF,
                               "step": int(step),
                               "begin_unix": begin_unix,
                               "begin_mono": time.monotonic(),
                               "phase": "begin"}

    def set_phase(self, key: int, phase: str) -> None:
        """Mark which phase the in-flight step is executing — the
        field a stall diagnosis reads off /llm/steps."""
        with self._lock:
            live = self._live.get(key)
            if live is not None:
                live["phase"] = phase

    def live(self) -> List[Dict[str, Any]]:
        """Snapshot of in-flight steps with a computed ``age_s``
        (monotonic now minus the monotonic begin stamp)."""
        now = time.monotonic()
        with self._lock:
            return [dict(d, age_s=round(now - d["begin_mono"], 4))
                    for d in self._live.values()]

    # -- finished step records ----------------------------------------

    def record(self, key: int, rec: Dict[str, Any]) -> None:
        """Append one finished step record, clear the engine's live
        entry, and observe the llm_step_phase_ms{phase=} histograms."""
        if not _metrics.enabled():
            with self._lock:
                self._live.pop(key, None)
            return
        with self._lock:
            self._live.pop(key, None)
            self._buf.append(rec)
            n = len(self._buf)
        hist = _metrics.histogram(
            "llm_step_phase_ms",
            "wall time of one LLM engine step phase (admit / prefill "
            "/ decode / spec_verify, plus the sample and scatter "
            "sub-segments) — the /llm/steps ring's histogram view",
            buckets=_metrics.LATENCY_MS_BUCKETS)
        for phase, ms in (rec.get("phase_ms") or {}).items():
            hist.observe(float(ms), phase=phase)
        _metrics.gauge("llm_trace_ring_entries").set(
            float(n), ring="steps")

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last view of the last ``n`` step records (all by
        default)."""
        with self._lock:
            out = [dict(r) for r in self._buf]
        if n is not None and n >= 0:
            out = out[-n:] if n else []
        return out

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def resize(self, capacity: int) -> None:
        """Rebuild at a new capacity keeping the newest records
        (FLAGS_llm_step_ring on_change hook)."""
        with self._lock:
            self._buf = deque(self._buf, maxlen=max(8, int(capacity)))

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self._live.clear()


_RING = StepRecordRing()


def ring() -> StepRecordRing:
    return _RING
