"""Size-capped JSONL appends and prefix-pruned dump directories.

Counterpart of ``paddle_tpu.observability.rotation``.

Long runs append structured events (``events.jsonl`` from the anomaly
sentinel, crash dumps from the flight recorder) for days; without a cap
they eventually fill the disk and take the training job down with an
OSError in a telemetry path — the one place that must never hurt the
run. Two primitives, shared by both writers:

- :func:`append_jsonl` — append records to a JSONL file, rolling it to
  ``<path>.1`` once it exceeds ``max_bytes`` (one predecessor kept, so
  the tail of history survives the roll).
- :func:`prune_prefixed` — keep only the newest ``keep`` files matching
  a prefix in a directory (one-shot dump files like
  ``flight_<ts>.jsonl``).

Every function swallows OSError: a full disk degrades telemetry, never
the training loop (same contract as the anomaly sentinel's original
writer).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["append_jsonl", "prune_prefixed", "DEFAULT_MAX_BYTES"]

# events.jsonl records are ~150 bytes; 16 MB keeps ~100k events per
# generation — days of anomalies — while bounding disk to 32 MB total.
DEFAULT_MAX_BYTES = 16 * 1024 * 1024


def _rollover(path: str, max_bytes: int, keep: int) -> None:
    """Roll ``path`` to ``path.1`` (…``path.<keep-1>``) when it exceeds
    ``max_bytes``; the oldest generation is replaced."""
    try:
        if os.path.getsize(path) < max_bytes:
            return
    except OSError:  # missing file: nothing to roll
        return
    try:
        for i in range(keep - 1, 0, -1):
            src = path if i == 1 else f"{path}.{i - 1}"
            os.replace(src, f"{path}.{i}")
    # ptlint: disable=silent-failure -- log rotation on a sick disk: the append below will surface (and also swallow) the same condition; logging must not kill training
    except OSError:
        pass


def append_jsonl(path: str, records: Iterable[Dict[str, Any]],
                 max_bytes: Optional[int] = None,
                 keep: int = 2) -> None:
    """Append ``records`` (one JSON object per line) to ``path`` with
    size-based rollover: once the file passes ``max_bytes`` (default
    DEFAULT_MAX_BYTES, resolved at call time) it becomes ``path.1`` and
    a fresh file starts (``keep`` generations total)."""
    if max_bytes is None:
        max_bytes = DEFAULT_MAX_BYTES
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _rollover(path, max_bytes, keep)
        with open(path, "a") as f:
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
    # ptlint: disable=silent-failure -- full disk must not take down the training loop; event logs are best-effort by contract
    except OSError:
        pass  # full disk must not take down the training loop


def prune_prefixed(directory: str, prefix: str, keep: int = 2) -> List[str]:
    """Delete all but the ``keep`` newest (by name — timestamped names
    sort chronologically) files starting with ``prefix``; returns the
    surviving paths."""
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith(prefix))
    except OSError:
        return []
    for n in names[:-keep] if keep > 0 else names:
        try:
            os.remove(os.path.join(directory, n))
        # ptlint: disable=silent-failure -- pruning a rotated log that a racing process already removed (or a sick disk) is not an error worth failing over
        except OSError:
            pass
    return [os.path.join(directory, n) for n in names[-keep:]]
