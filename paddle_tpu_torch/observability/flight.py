"""Crash flight recorder: last-N structured events + dump-on-death.

When a production job dies — SIGTERM from the scheduler, an uncaught
exception, a wedged collective killed by a watchdog — the logs usually
show *that* it died, not what the process was doing in the seconds
before. The flight recorder answers that without a rerun: a lock-cheap
in-process ring buffer keeps the last ``FLAGS_flight_buffer_events``
structured events (step markers, recompiles, anomalies, ledger
transitions, straggler flags, elastic restarts), and installed
signal/atexit/excepthook hooks dump it as ``flight_<ts>.jsonl`` under
``FLAGS_trace_dir`` together with a final metrics snapshot when the
process goes down. The live buffer is browsable at ``/flight`` on the
observability server.

Recording is gated on FLAGS_enable_metrics like every other
instrument; one ``record()`` is a time.time() + deque.append under a
lock — no serialization, no I/O. Dumps reuse :mod:`rotation` so
repeated crashes keep only the newest two files.

The dump file is line-parseable: a ``flight_header`` record first,
one record per buffered event, and a closing ``final_metrics`` record
carrying the registry + goodput snapshots and the SLO verdict + tsdb
ring state; a fatal-signal dump also records every thread's stack.

Counterpart of ``paddle_tpu.observability.flight``, the same event
layout.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..flags import GLOBAL_FLAGS
from . import metrics as _metrics
from . import rotation as _rotation

__all__ = ["FlightRecorder", "recorder", "record", "install", "dump"]


def _capacity() -> int:
    return max(8, int(GLOBAL_FLAGS.get("flight_buffer_events")))


def _trace_dir() -> str:
    return GLOBAL_FLAGS.get("trace_dir") or ""


class FlightRecorder:
    """Bounded event ring with crash hooks."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity or _capacity())  # guarded-by: self._lock
        self._installed = False
        self._prev_handlers: Dict[int, Any] = {}
        self._prev_excepthook = None
        self._dumped_reasons: List[str] = []

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, force: bool = False, **data) -> None:
        """Append one structured event; a no-op while metrics are off
        (``force=True`` is the explicit-caller path, e.g. the launcher
        process which never flips the flag)."""
        if not (force or _metrics.enabled()):
            return
        ev = {"ts_unix": time.time(), "kind": kind}
        ev.update(data)
        with self._lock:
            self._buf.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
        self._dumped_reasons.clear()

    def resize(self, capacity: int) -> None:
        """Rebuild the ring at a new capacity, keeping the newest
        events (FLAGS_flight_buffer_events on_change hook)."""
        with self._lock:
            self._buf = deque(self._buf, maxlen=max(8, int(capacity)))

    # -- dumping -----------------------------------------------------------

    def dump(self, reason: str, directory: Optional[str] = None) -> str:
        """Write ``flight_<ts>.jsonl`` (header, events, final metrics
        snapshot) into ``directory`` (default FLAGS_trace_dir); returns
        the path, or "" when there is nowhere to write."""
        directory = directory or _trace_dir()
        if not directory:
            return ""
        events = self.events()
        ts = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(directory, f"flight_{ts}-{os.getpid()}.jsonl")
        header = {"kind": "flight_header", "reason": reason,
                  "ts_unix": time.time(), "pid": os.getpid(),
                  "events": len(events), "capacity": self.capacity}
        try:
            snap: Dict[str, Any] = {"metrics": _metrics.registry().snapshot()}
            from . import goodput as _goodput
            snap["goodput"] = _goodput.ledger().snapshot()
        except Exception:  # noqa: BLE001 — a dump must never raise
            snap = {"metrics": {}}
        try:
            # the SLO verdict + tsdb ring state must survive a crash
            # the same way the registry does (the alert that was
            # firing when the process died is the postmortem headline)
            from . import slo as _slo
            from . import tsdb as _tsdb
            snap["alerts"] = _slo.engine().alerts_view()
            snap["tsdb"] = _tsdb.ring().stats()
        # ptlint: disable=silent-failure -- a dump must never raise; the final record simply ships without the SLO section
        except Exception:  # noqa: BLE001
            pass
        final = {"kind": "final_metrics", "ts_unix": time.time()}
        final.update(snap)
        try:
            os.makedirs(directory, exist_ok=True)
            with open(path, "w") as f:
                for rec in [header] + events + [final]:
                    f.write(json.dumps(rec, default=str) + "\n")
        except OSError:
            return ""
        self._dumped_reasons.append(reason)
        _rotation.prune_prefixed(directory, "flight_", keep=2)
        return path

    # -- crash hooks -------------------------------------------------------

    def install(self, signals=(signal.SIGTERM,)) -> bool:
        """Install signal/atexit/excepthook dump hooks (idempotent).
        Returns False when handlers cannot be installed (non-main
        thread); the atexit/excepthook pair still goes in."""
        if self._installed:
            return True
        self._installed = True
        atexit.register(self._on_exit)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        ok = True
        for sig in signals:
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._on_signal)
            except (ValueError, OSError):  # not the main thread
                ok = False
        return ok

    def _on_signal(self, signum, frame) -> None:
        self.record("signal", force=True, signum=int(signum))
        try:
            # all-thread stacks ride the fatal dump: the last question
            # a postmortem asks is "what was every thread executing"
            from . import stacks as _stacks
            _stacks.dump_to_flight(f"signal:{int(signum)}")
        # ptlint: disable=silent-failure -- the dump itself must proceed even if stack capture breaks mid-death
        except Exception:  # noqa: BLE001
            pass
        self.dump(f"signal:{int(signum)}")
        prev = self._prev_handlers.get(signum)
        # restore whatever was there and re-deliver, so the process
        # still dies with the correct wait-status (the dump is a detour,
        # not a rescue)
        signal.signal(signum, prev if callable(prev)
                      else signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    def _on_exception(self, exc_type, exc, tb) -> None:
        self.record("uncaught_exception", force=True,
                    type=getattr(exc_type, "__name__", str(exc_type)),
                    message=str(exc)[:500])
        self.dump(f"exception:{getattr(exc_type, '__name__', '?')}")
        hook = self._prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)

    def _on_exit(self) -> None:
        # only dump at exit if nothing else already captured the death;
        # a clean exit with trace_dir set still leaves a black box
        if not self._dumped_reasons and _trace_dir() \
                and (self.events() or _metrics.enabled()):
            self.dump("atexit")


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, force: bool = False, **data) -> None:
    """Module-level shortcut used by the instrumentation sites."""
    _RECORDER.record(kind, force=force, **data)


def install(**kwargs) -> bool:
    return _RECORDER.install(**kwargs)


def dump(reason: str, directory: Optional[str] = None) -> str:
    return _RECORDER.dump(reason, directory)
