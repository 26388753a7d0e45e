"""Per-sequence lifecycle timelines: the /llm/seqs store.

Counterpart of ``paddle_tpu.observability.seqtrace``, the same records.

One timeline per LLM-engine sequence, from ``add_request`` to its
terminal outcome, built from the engine-side events the serving flight
deck joins against step records::

    queued -> admitted|readmitted -> prefill_chunk x N -> cow_copy
           -> preempted -> spec_window{proposed,accepted,rollback}
           -> token x N -> finished|shed|cancelled|error

Every event is stamped from ``time.monotonic()`` — the engine is all
one process, and gap attribution subtracts these stamps, so they must
come from the monotonic clock. The single wall
stamp (``begin_unix``) is display-only and never subtracted; the wire
boundary keeps its own wall stamps in reqtrace. ``trace_id`` is the
wire trace id carried through the bridge so one id walks
``/requests`` -> ``/llm/seqs``.

Shape of the store: LIVE timelines sit in a dict keyed by seq_id
(naturally bounded by the engine's live set); a terminal outcome moves
the timeline into a bounded deque of finished timelines
(``FLAGS_llm_seqtrace_ring``, rotation-style: oldest evicted first).
Per-timeline events are capped at :data:`EVENT_CAP` — past it,
non-terminal events are dropped and counted in ``events_dropped``
instead of growing without bound under a long generation. Timelines
that end in ``error``/``cancelled``/``shed`` are also dumped into the
crash flight recorder so a post-mortem survives the ring.

Recording is gated on ``FLAGS_enable_metrics`` like every instrument:
one event is a dict append under a lock. Engine seq_ids are
per-engine counters, so with several engines in one process a seq_id
can recur: ``begin`` then retires the previous timeline with outcome
``superseded`` (each timeline still carries its ``engine`` key).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..flags import GLOBAL_FLAGS
from . import flight as _flight
from . import metrics as _metrics

__all__ = ["SeqTraceRing", "ring", "begin", "event", "finish",
           "EVENT_CAP"]

# per-timeline event bound: past this, non-terminal events are counted
# in events_dropped instead of appended (a monster generation must not
# grow one timeline without limit)
EVENT_CAP = 2048

# terminal outcomes that dump the timeline into the flight recorder
# (post-mortems must survive ring eviction)
_FLIGHT_OUTCOMES = ("error", "cancelled", "shed")

# at most this many trailing events ride along in the flight dump
_FLIGHT_EVENT_TAIL = 64


def _capacity() -> int:
    return max(8, int(GLOBAL_FLAGS.get("llm_seqtrace_ring")))


def _publish_sizes(live: int, done: int) -> None:
    _metrics.gauge(
        "llm_trace_ring_entries",
        "entries held by the serving flight-deck stores "
        "(ring=seqs_live: in-flight sequence timelines, "
        "ring=seqs_finished: terminal timelines in the "
        "FLAGS_llm_seqtrace_ring deque, ring=steps: engine step "
        "records in the FLAGS_llm_step_ring deque)").set(
            float(live), ring="seqs_live")
    _metrics.gauge("llm_trace_ring_entries").set(
        float(done), ring="seqs_finished")


class SeqTraceRing:
    """Live timelines by seq_id + bounded deque of finished ones."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        # seq_id -> timeline dict            # guarded-by: self._lock
        self._live: Dict[int, Dict[str, Any]] = {}
        # finished timelines, oldest first   # guarded-by: self._lock
        self._done: deque = deque(maxlen=capacity or _capacity())

    # -- recording ----------------------------------------------------

    def begin(self, seq_id: int, trace_id: int = 0,
              engine: int = 0, **data: Any) -> None:
        """Open a timeline (engine ``add_request``). No-op while
        metrics are off. A live timeline already holding this seq_id
        (another engine, or a reset race) is retired as
        ``superseded`` rather than silently overwritten."""
        if not _metrics.enabled():
            return
        tl = {"seq_id": int(seq_id), "trace_id": int(trace_id),
              "engine": int(engine) & 0xFFFF,
              "begin_unix": time.time(),  # display only, never subtracted
              "begin_mono": time.monotonic(),
              "outcome": None, "events_dropped": 0,
              "events": [{"ev": "queued", "t_mono": time.monotonic()}],
              **data}
        with self._lock:
            prev = self._live.pop(seq_id, None)
            if prev is not None:
                prev["outcome"] = "superseded"
                self._done.append(prev)
            self._live[seq_id] = tl
            live, done = len(self._live), len(self._done)
        _publish_sizes(live, done)

    def event(self, seq_id: int, ev: str, **data: Any) -> None:
        """Append one monotonic-stamped event to a live timeline.
        Unknown seq_ids (timeline finished, metrics flipped on
        mid-flight) are a silent no-op by design."""
        if not _metrics.enabled():
            return
        with self._lock:
            tl = self._live.get(seq_id)
            if tl is None:
                return
            if len(tl["events"]) >= EVENT_CAP:
                tl["events_dropped"] += 1
                return
            tl["events"].append(
                {"ev": ev, "t_mono": time.monotonic(), **data})

    def finish(self, seq_id: int, outcome: str, **data: Any) -> None:
        """Close a timeline with a terminal outcome (finished / shed /
        cancelled / error) and move it into the finished deque; sad
        outcomes also dump into the flight recorder."""
        if not _metrics.enabled():
            return
        with self._lock:
            tl = self._live.pop(seq_id, None)
            if tl is None:
                return
            tl["outcome"] = outcome
            tl["events"].append(
                {"ev": outcome, "t_mono": time.monotonic(), **data})
            tl.update(data)
            self._done.append(tl)
            live, done = len(self._live), len(self._done)
        _publish_sizes(live, done)
        if outcome in _FLIGHT_OUTCOMES:
            _flight.record(
                "seq_timeline", force=True, seq_id=tl["seq_id"],
                trace_id=tl["trace_id"], outcome=outcome,
                events=len(tl["events"]),
                events_dropped=tl["events_dropped"],
                timeline=[dict(e) for e
                          in tl["events"][-_FLIGHT_EVENT_TAIL:]])

    # -- views --------------------------------------------------------

    def live(self) -> List[Dict[str, Any]]:
        """Snapshot of in-flight timelines (events copied)."""
        with self._lock:
            return [dict(tl, events=[dict(e) for e in tl["events"]])
                    for tl in self._live.values()]

    def recent(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """Newest-last view of the last ``n`` finished timelines (all
        by default)."""
        with self._lock:
            out = [dict(tl, events=[dict(e) for e in tl["events"]])
                   for tl in self._done]
        if n is not None and n >= 0:
            out = out[-n:] if n else []
        return out

    def get(self, seq_id: int) -> Optional[Dict[str, Any]]:
        """The live timeline for ``seq_id``, else its newest finished
        one, else None."""
        with self._lock:
            tl = self._live.get(seq_id)
            if tl is None:
                for cand in reversed(self._done):
                    if cand["seq_id"] == seq_id:
                        tl = cand
                        break
            if tl is None:
                return None
            return dict(tl, events=[dict(e) for e in tl["events"]])

    def find(self, trace_id: int) -> List[Dict[str, Any]]:
        """Every timeline (live + finished) carrying this wire
        trace_id — the /requests -> /llm/seqs join key."""
        with self._lock:
            hits = [tl for tl in self._done
                    if tl["trace_id"] == trace_id]
            hits += [tl for tl in self._live.values()
                     if tl["trace_id"] == trace_id]
            return [dict(tl, events=[dict(e) for e in tl["events"]])
                    for tl in hits]

    @property
    def capacity(self) -> int:
        return self._done.maxlen or 0

    def resize(self, capacity: int) -> None:
        """Rebuild the finished deque at a new capacity keeping the
        newest timelines (FLAGS_llm_seqtrace_ring on_change hook)."""
        with self._lock:
            self._done = deque(self._done,
                               maxlen=max(8, int(capacity)))

    def reset(self) -> None:
        with self._lock:
            self._live.clear()
            self._done.clear()


_RING = SeqTraceRing()


def ring() -> SeqTraceRing:
    return _RING


def begin(seq_id: int, trace_id: int = 0, engine: int = 0,
          **data: Any) -> None:
    _RING.begin(seq_id, trace_id=trace_id, engine=engine, **data)


def event(seq_id: int, ev: str, **data: Any) -> None:
    _RING.event(seq_id, ev, **data)


def finish(seq_id: int, outcome: str, **data: Any) -> None:
    _RING.finish(seq_id, outcome, **data)
