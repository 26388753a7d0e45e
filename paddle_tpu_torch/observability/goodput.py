"""Goodput ledger: exclusive wall-time accounting of a training run.

Counterpart of ``paddle_tpu.observability.goodput``: the same buckets,
self-time semantics, snapshot layout and series. :class:`GoodputLedger`
classifies every second of a training loop's wall time into
**exclusive** buckets::

    step_compute          the train step itself (the goodput)
    jit_compile_cold      calls that captured a step (the port's
                          counterpart of a jit trace + compile: the eager
                          warm-up step and the CUDA-graph capture, from
                          the capture tracker)
    jit_compile_cache_hit always 0 here, by design: a CUDA graph does not
                          outlive its process, so the port has no
                          persistent compile cache to hit
    data_wait             blocking on the DataLoader for the next batch
    eval                  in-loop evaluation passes
    checkpoint            the host-blocking part of a save
                          (io.AsyncCheckpointer.save / wait)
    restart_idle          elastic relaunch dead time (PT_RESTART_IDLE_S)
    other                 wall time no instrument claimed (the residual,
                          so buckets always sum to wall time)

Nested measurements use self-time semantics (a checkpoint saved inside
an eval pass is charged to ``checkpoint`` only). Published as
``goodput_ratio``, ``goodput_wall_seconds``, ``goodput_seconds_total``
and ``badput_seconds_total{bucket=}``, served live at ``/goodput``.

:func:`flag_stragglers` is the pure straggler policy; the JAX
``StragglerDetector`` (a step-time all-gather over a mesh) comes with the
port's multi-host tier.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import numpy as np

from . import flight as _flight
from . import metrics as _metrics
from . import recompile as _recompile

__all__ = ["BUCKETS", "GOODPUT_BUCKET", "GoodputLedger", "ledger",
           "compile_seconds_total", "compile_cache_stats",
           "classify_compile_bucket", "flag_stragglers"]

GOODPUT_BUCKET = "step_compute"
BUCKETS = (GOODPUT_BUCKET, "jit_compile_cold", "jit_compile_cache_hit",
           "data_wait", "eval", "checkpoint", "restart_idle", "other")

# process-start anchor: a relaunched elastic worker charges the time
# from interpreter start to its first ledger.start() as restart_idle
_IMPORT_T0 = time.perf_counter()


class GoodputLedger:
    """Exclusive wall-time accounting for a training process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seconds: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._t0: Optional[float] = None
        self._prior_wall = 0.0
        self._seeded_restart = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Open the wall clock (idempotent while running). On the first
        start of a relaunched elastic worker, seeds ``restart_idle``
        with the launcher's hand-off plus this process's own start-up
        time."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.perf_counter()
            if not self._seeded_restart:
                self._seeded_restart = True
                idle = 0.0
                # a malformed launcher env var degrades to "no seeded
                # idle", not a failed run
                try:
                    idle += float(os.environ.get("PT_RESTART_IDLE_S", 0))
                except ValueError:
                    pass
                try:
                    if int(os.environ.get("PT_ELASTIC_ATTEMPT", 0)) > 0:
                        # relaunch: everything before the run resumed is
                        # restart dead time (imports, checkpoint find)
                        idle += time.perf_counter() - _IMPORT_T0
                except ValueError:
                    pass
                if idle > 0:
                    self._seconds["restart_idle"] += idle
                    self._prior_wall += idle
                    _flight.record("ledger", bucket="restart_idle",
                                   seconds=round(idle, 6))

    def stop(self) -> None:
        """Close the wall clock; the unattributed residual up to now is
        folded into ``other`` so a later ``start()`` keeps the books
        exclusive across multiple fits."""
        with self._lock:
            if self._t0 is None:
                return
            wall = self._prior_wall + (time.perf_counter() - self._t0)
            self._t0 = None
            self._prior_wall = wall
            accounted = sum(self._seconds.values())
            if wall > accounted:
                self._seconds["other"] += wall - accounted

    def running(self) -> bool:
        return self._t0 is not None

    def wall_seconds(self) -> float:
        with self._lock:
            live = (time.perf_counter() - self._t0) \
                if self._t0 is not None else 0.0
            return self._prior_wall + live

    # -- attribution -------------------------------------------------------

    def attribute(self, bucket: str, seconds: float) -> None:
        """Charge ``seconds`` to ``bucket`` (direct, non-nesting path —
        the fit loop's per-step data_wait/compile/compute splits)."""
        if seconds <= 0:
            return
        with self._lock:
            self._seconds[bucket] = self._seconds.get(bucket, 0.0) \
                + seconds

    @contextmanager
    def measure(self, bucket: str, flight_event: bool = True):
        """Charge the block's SELF time to ``bucket``: time spent in a
        nested ``measure`` goes to the inner bucket only (exclusivity).
        No-op unless the ledger is running and metrics are on."""
        if not (self.running() and _metrics.enabled()):
            yield
            return
        stack: List[Dict[str, float]] = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        frame = {"child": 0.0}
        stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            self.attribute(bucket, max(0.0, dt - frame["child"]))
            if stack:
                stack[-1]["child"] += dt
            if flight_event:
                _flight.record("ledger", bucket=bucket,
                               seconds=round(dt, 6))

    # -- views -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able ledger: per-bucket seconds (with the live residual
        shown as ``other``), ratios that sum to 1, and the goodput
        headline."""
        wall = self.wall_seconds()
        with self._lock:
            buckets = dict(self._seconds)
        accounted = sum(buckets.values())
        if wall > accounted:
            buckets["other"] += wall - accounted
        else:
            # measured time can exceed the wall clock only by timer
            # jitter; pin wall to the accounted sum so ratios stay valid
            wall = accounted
        ratios = {b: (s / wall if wall > 0 else 0.0)
                  for b, s in buckets.items()}
        return {"wall_seconds": wall,
                "buckets": buckets,
                "ratios": ratios,
                "goodput_seconds": buckets[GOODPUT_BUCKET],
                "goodput_ratio": ratios[GOODPUT_BUCKET],
                "running": self.running()}

    def publish(self) -> None:
        """Write the snapshot onto the metrics registry (scraped pages
        and metrics.prom; /goodput and metrics.json read the ledger
        directly)."""
        if not _metrics.enabled():
            return
        snap = self.snapshot()
        _metrics.gauge(
            "goodput_ratio",
            "fraction of fit() wall time spent in the train step "
            "itself").set(snap["goodput_ratio"])
        _metrics.gauge(
            "goodput_wall_seconds",
            "wall seconds covered by the goodput ledger"
        ).set(snap["wall_seconds"])
        good = _metrics.counter(
            "goodput_seconds_total",
            "ledger seconds in the goodput bucket (step_compute)")
        good.set_total(snap["buckets"][GOODPUT_BUCKET])
        bad = _metrics.counter(
            "badput_seconds_total",
            "ledger seconds per non-goodput bucket "
            "(jit_compile_cold | jit_compile_cache_hit | data_wait | "
            "eval | checkpoint | restart_idle | other)")
        for b, s in snap["buckets"].items():
            if b != GOODPUT_BUCKET:
                bad.set_total(s, bucket=b)
        stats = compile_cache_stats()
        _metrics.counter(
            "compile_cache_hits_total",
            "persistent compile cache hits (executables loaded from "
            "FLAGS_compile_cache_dir instead of compiled)"
        ).set_total(stats["hits"])
        _metrics.counter(
            "compile_cache_misses_total",
            "persistent compile cache misses (cold compiles written "
            "through to FLAGS_compile_cache_dir)"
        ).set_total(stats["misses"])

    def reset(self) -> None:
        with self._lock:
            self._seconds = {b: 0.0 for b in BUCKETS}
            self._t0 = None
            self._prior_wall = 0.0
            self._seeded_restart = False


def compile_seconds_total() -> float:
    """Total capture seconds seen by the capture tracker (each captured
    step's warm-up plus capture, the port's counterpart of a jit
    compile): a training loop diffs this around each step call to split
    the step's wall time into jit_compile_cold vs step_compute."""
    total = 0.0
    for rec in _recompile.tracker().snapshot().values():
        total += sum(rec.get("compile_times_s", ()))
    return total


def compile_cache_stats() -> Dict[str, int]:
    """Persistent compile cache hits/misses: always 0 in the port (a
    CUDA graph does not outlive its process, so there is no persistent
    cache); kept so the JAX series and call sites read alike."""
    return {"hits": 0, "misses": 0}


def classify_compile_bucket(cache_before: Dict[str, int]) -> str:
    """Which jit_compile bucket a just-measured capture's seconds belong
    to: always ``jit_compile_cold``, by design. The JAX package books a
    trace served by its persistent compile cache as
    ``jit_compile_cache_hit``; the port has no persistent cache (a CUDA
    graph is captured anew in every process), so that bucket exists and
    stays 0."""
    return "jit_compile_cold"


_LEDGER = GoodputLedger()


def ledger() -> GoodputLedger:
    return _LEDGER


# ---------------------------------------------------------------------------
# straggler policy
# ---------------------------------------------------------------------------

def flag_stragglers(times, factor: float) -> List[int]:
    """Pure policy: indices whose time exceeds ``factor`` x median.
    ``times`` is any sequence of per-host step seconds."""
    t = np.asarray(times, dtype=np.float64).reshape(-1)
    if t.size < 2 or factor <= 0:
        return []
    med = float(np.median(t))
    if med <= 0:
        return []
    return [int(i) for i in np.nonzero(t > factor * med)[0]]
