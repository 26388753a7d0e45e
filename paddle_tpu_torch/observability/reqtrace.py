"""Per-request serving span records: the /requests ring.

Counterpart of ``paddle_tpu.observability.reqtrace``, the same records.

One record per request answered by ``inference.Server``, carrying the
five lifecycle timestamps stamped across the native transport and the
Python batcher::

    ingress    reader thread parsed the frame (csrc/serving.cc, unix
               microseconds from the same realtime clock Python reads)
    dequeue    the batcher drained it off the native queue
    assembly   its dynamic batch closed (the wait_ms window ended)
    dispatch   handed to the engine (a stream's first prefill)
    reply      the reply frame was written back

and the derived spans published as the ``serving_*_ms`` histograms
(``queue_wait`` = dequeue−ingress, ``batch_assembly`` =
assembly−dequeue, ``compute`` = reply−dispatch, ``e2e`` =
reply−ingress). The ring keeps the last ``FLAGS_serving_request_ring``
records (the JAX package serves them at ``/requests?n=`` on its HTTP
exporter, which the port has not yet).

Recording is gated on ``FLAGS_enable_metrics`` like every instrument:
one ``record()`` is a dict build + deque append under a lock. A record
whose spans are inconsistent (a negative duration — clock step or a
stamping bug) is still kept but flagged ``anomaly: true`` and routed to
the flight recorder, so a crash dump tells the request-level story.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional

from ..flags import GLOBAL_FLAGS
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["RequestTraceRing", "ring", "record", "recent"]

# timestamp keys in lifecycle order; every consecutive pair must be
# non-decreasing for the record to be anomaly-free
STAMPS = ("ingress_unix", "dequeue_unix", "assembly_unix",
          "dispatch_unix", "reply_unix")


def _capacity() -> int:
    return max(8, int(GLOBAL_FLAGS.get("serving_request_ring")))


class RequestTraceRing:
    """Bounded ring of per-request span records."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity or _capacity())

    def record(self, rec: Dict[str, Any]) -> None:
        """Append one span record (no-op while metrics are off).
        Validates timestamp ordering; out-of-order stamps mark the
        record ``anomaly`` and emit a ``reqtrace_anomaly`` flight
        event instead of being silently dropped."""
        if not _metrics.enabled():
            return
        present = [(k, rec[k]) for k in STAMPS
                   if rec.get(k) is not None]
        for (ka, va), (kb, vb) in zip(present, present[1:]):
            if vb < va:
                rec = dict(rec, anomaly=True)
                _flight.record("reqtrace_anomaly",
                               trace_id=rec.get("trace_id"),
                               first=ka, then=kb,
                               skew_ms=round((va - vb) * 1e3, 3))
                break
        with self._lock:
            self._buf.append(rec)

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last view of the last ``n`` records (all by default)."""
        with self._lock:
            out = list(self._buf)
        if n is not None and n >= 0:
            out = out[-n:] if n else []
        return out

    def find(self, trace_id: int) -> Optional[Dict[str, Any]]:
        """Newest record carrying ``trace_id`` (tests/debugging)."""
        with self._lock:
            for rec in reversed(self._buf):
                if rec.get("trace_id") == trace_id:
                    return rec
        return None

    @property
    def capacity(self) -> int:
        return self._buf.maxlen or 0

    def resize(self, capacity: int) -> None:
        """Rebuild at a new capacity keeping the newest records
        (FLAGS_serving_request_ring on_change hook)."""
        with self._lock:
            self._buf = deque(self._buf, maxlen=max(8, int(capacity)))

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()


_RING = RequestTraceRing()


def ring() -> RequestTraceRing:
    return _RING


def record(rec: Dict[str, Any]) -> None:
    _RING.record(rec)


def recent(n: Optional[int] = None) -> List[Dict[str, Any]]:
    return _RING.recent(n)
