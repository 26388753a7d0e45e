"""Chrome-trace ``traceEvents`` aggregation.

Counterpart of ``paddle_tpu.observability.trace_agg``, the same
function names and result shapes: load a trace (plain ``.json`` or
gzipped), roll up device op times, and aggregate host spans into the
calls/total/avg/max summary table.

The device lane differs: the JAX roll-up keeps the "XLA Ops" lane of an
XLA profiler trace; a ``torch.profiler`` chrome trace has no such lane,
and its device work is the events of category ``kernel`` (plus
``gpu_memcpy`` / ``gpu_memset``), one per CUDA kernel (or copy) on a
stream of the card. :func:`xla_op_rollup` keeps only those, with their
category as the roll-up's category, and raises ``TraceFormatError`` for
a trace without any kernel event (a CPU-only profile), as the JAX one
does for a trace without its lane. Its step count is the number of
``ProfilerStep#N`` annotations (``torch.profiler.profile.step()``).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["load_trace_events", "find_xla_traces", "xla_op_rollup",
           "span_summary", "format_span_table", "format_xla_rollup",
           "TraceFormatError", "DEVICE_CATEGORIES"]


class TraceFormatError(ValueError):
    """Trace lacks the metadata needed for a reliable aggregation."""


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """Load ``traceEvents`` from a chrome-trace JSON file (gzipped or
    not; dict-with-traceEvents or bare event list)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    if isinstance(data, list):
        return data
    return data.get("traceEvents", [])


def find_xla_traces(root: str) -> List[str]:
    """The ``torch.profiler`` traces under ``root``: its TensorBoard
    handler writes ``**/*.pt.trace.json`` (``.gz`` when asked), and
    ``profiler.stop_profiler`` writes ``**/*.trace.json``."""
    found = set()
    for pat in ("*.trace.json", "*.trace.json.gz"):
        found.update(glob.glob(os.path.join(root, "**", pat),
                               recursive=True))
    return sorted(found)


# the categories of device work in a torch.profiler chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def xla_op_rollup(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate device op times from a ``torch.profiler`` chrome trace.

    Keeps ONLY the device lane: complete ("X") events whose ``cat`` is
    one of :data:`DEVICE_CATEGORIES` (host-side CUDA runtime calls and
    operator spans overlap the kernels they launch, so summing every
    event would double-count the step). Returns {"ops": {name:
    {"dur_us", "count"}}, "categories": {cat: dur_us}, "total_us",
    "steps"}; raises TraceFormatError when the trace holds no device
    event (a CPU-only profile: aggregating it would report a step with
    no device time)."""
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATEGORIES]
    if not device:
        raise TraceFormatError(
            "trace has no CUDA kernel events (cat 'kernel'); cannot "
            "aggregate device time (a CPU-only profile?)")
    durs: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    cats: Dict[str, float] = defaultdict(float)
    total = 0.0
    for e in device:
        name = e.get("name", "?")
        d = float(e.get("dur", 0.0))
        durs[name] += d
        counts[name] += 1
        cats[e["cat"]] += d
        total += d
    # per-step divisor: one ProfilerStep#N annotation per step
    steps = sum(1 for e in events if e.get("ph") == "X"
                and str(e.get("name", "")).startswith("ProfilerStep#"))
    return {"ops": {n: {"dur_us": d, "count": counts[n]}
                    for n, d in durs.items()},
            "categories": dict(cats), "total_us": total, "steps": steps}


def span_summary(events: Sequence[Dict[str, Any]],
                 prefix: str = "") -> Dict[str, Dict[str, float]]:
    """Per-name calls/total/avg/max over complete ("X") events, in µs.

    ``prefix`` tags names (e.g. "xla::") so host and device tables can
    merge without collisions.
    """
    agg: Dict[str, Dict[str, float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = prefix + e.get("name", "?")
        a = agg.setdefault(name, {"calls": 0, "total_us": 0.0,
                                  "max_us": 0.0})
        d = float(e.get("dur", 0.0))
        a["calls"] += 1
        a["total_us"] += d
        a["max_us"] = max(a["max_us"], d)
    for a in agg.values():
        a["avg_us"] = a["total_us"] / max(a["calls"], 1)
    return agg


def format_span_table(summary: Dict[str, Dict[str, float]],
                      top: Optional[int] = None,
                      title: str = "span summary") -> str:
    """Reference-style aggregated table, sorted by total time."""
    rows = sorted(summary.items(), key=lambda kv: -kv[1]["total_us"])
    if top is not None:
        rows = rows[:top]
    lines = [f"== {title} ({len(summary)} spans"
             + (f", top {len(rows)}" if top is not None else "") + ") ==",
             f"{'name':<48} {'calls':>7} {'total_ms':>10} "
             f"{'avg_ms':>9} {'max_ms':>9}"]
    for name, a in rows:
        lines.append(f"{name[:48]:<48} {a['calls']:>7d} "
                     f"{a['total_us'] / 1e3:>10.3f} "
                     f"{a['avg_us'] / 1e3:>9.3f} "
                     f"{a['max_us'] / 1e3:>9.3f}")
    return "\n".join(lines)


def format_xla_rollup(rollup: Dict[str, Any], top: int = 30) -> str:
    """The category + top-ops printout of a device roll-up, as a
    string."""
    total = rollup["total_us"]
    steps = rollup["steps"] or 1
    lines = [f"== device kernel time rollup (total {total / 1e3:.2f} ms, "
             f"{rollup['steps']} steps, "
             f"{total / steps / 1e3:.2f} ms/step) =="]
    for c, d in sorted(rollup["categories"].items(),
                       key=lambda kv: -kv[1]):
        pct = d / total * 100 if total else 0.0
        lines.append(f"  {c:24s} {d / steps / 1e3:9.3f} ms/step "
                     f"{pct:5.1f}%")
    lines.append("")
    lines.append(f"== top {top} ops by total duration ==")
    for name, op in sorted(rollup["ops"].items(),
                           key=lambda kv: -kv[1]["dur_us"])[:top]:
        lines.append(f"  {op['dur_us'] / steps / 1e3:9.3f} ms/step "
                     f"x{op['count']:<5d} {name[:100]}")
    return "\n".join(lines)
