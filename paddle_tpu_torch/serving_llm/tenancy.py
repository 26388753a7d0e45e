"""Tenant identity and SLO classes for the serving plane.

Counterpart of ``paddle_tpu.serving_llm.tenancy``, carried over as it
is (numpy and the standard library only). Every request may carry a
**tenant id** (who pays for the tokens) and a **priority class** (what
the tenant bought). Three classes exist, ordered — ``bulk`` <
``standard`` < ``premium`` — and the policy keys off that order:

* the scheduler preempts the lowest class first and never lets a
  lower-class grower evict a higher-class resident,
* the admission gate charges each tenant against its own KV-block
  budget (``FLAGS_tenant_kv_budget``) before the global watermark.

On the wire, identity is one optional trailing uint8 tensor holding the
UTF-8 bytes ``tenant \\x00 class``; absent, every layer defaults to
``tenant=default / class=standard``.

``tenant_label`` bounds metric-label cardinality: the first
``FLAGS_tenant_label_max`` distinct tenant ids pass through verbatim,
the rest hash into 16 stable overflow labels (crc32, not Python
``hash`` — label identity must survive interpreter restarts).
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from ..flags import GLOBAL_FLAGS

__all__ = ["CLASSES", "DEFAULT_TENANT", "DEFAULT_CLASS", "class_rank",
           "normalize_class", "parse_spec", "tenant_weight",
           "tenant_budget_frac", "tenant_label", "encode_descriptor",
           "decode_descriptor", "reset_labels"]

# priority classes in shed order: bulk degrades first, premium last
CLASSES = ("bulk", "standard", "premium")
_RANK = {name: i for i, name in enumerate(CLASSES)}

DEFAULT_TENANT = "default"
DEFAULT_CLASS = "standard"

# tenant ids are operator-facing strings; keep them printable and
# short so they can ride metric labels and log lines unescaped
_MAX_NAME = 64

# overflow hash buckets once FLAGS_tenant_label_max distinct tenants
# have claimed verbatim labels
_N_BUCKETS = 16

_label_lock = threading.Lock()
# tenant ids that hold a verbatim label   # guarded-by: _label_lock
_label_claimed: Dict[str, str] = {}


def normalize_class(name: Optional[str]) -> str:
    """Map any wire/API value onto a known class; unknown strings
    degrade to ``standard`` (never an error: a newer client's class
    name must not kill its request on an older server)."""
    if isinstance(name, str) and name in _RANK:
        return name
    return DEFAULT_CLASS


def class_rank(name: Optional[str]) -> int:
    """Shed/preemption order of a class: bulk=0 < standard=1 <
    premium=2. Unknown names rank as ``standard``."""
    return _RANK[normalize_class(name)]


def sanitize_tenant(name: Optional[str]) -> str:
    """Clamp a tenant id to a printable, bounded string (empty or
    non-string degrades to ``default``)."""
    if not isinstance(name, str) or not name:
        return DEFAULT_TENANT
    clean = "".join(c if c.isprintable() and c not in ",= " else "_"
                    for c in name[:_MAX_NAME])
    return clean or DEFAULT_TENANT


def parse_spec(spec: str) -> Dict[str, float]:
    """Parse a ``tenant=value,tenant=value`` flag string (weights or
    budget fractions). Malformed entries are skipped, not fatal — a
    typo in an operator flag must degrade to the default policy for
    that tenant, never take the serving loop down."""
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        try:
            out[sanitize_tenant(name.strip())] = float(val)
        except ValueError:
            continue
    return out


def _flag(name: str) -> str:
    return str(GLOBAL_FLAGS.get(name))


def tenant_weight(tenant: str) -> float:
    """Fair-share weight from ``FLAGS_tenant_weights``; tenants not in
    the spec weigh 1.0. Weight 0 is legal: the tenant only runs when
    every weighted tenant is idle (the starvation floor keeps it
    progressing then)."""
    return parse_spec(_flag("tenant_weights")).get(tenant, 1.0)


def tenant_budget_frac(tenant: str) -> Optional[float]:
    """Per-tenant KV budget from ``FLAGS_tenant_kv_budget`` as a
    fraction of the pool, or None when the tenant is uncapped."""
    frac = parse_spec(_flag("tenant_kv_budget")).get(tenant)
    if frac is None:
        return None
    return min(max(frac, 0.0), 1.0)


def _label_max() -> int:
    return max(1, int(GLOBAL_FLAGS.get("tenant_label_max")))


def tenant_label(tenant: str) -> str:
    """Bounded-cardinality metric label for a tenant id: verbatim for
    the first ``FLAGS_tenant_label_max`` distinct tenants seen by this
    process, then a stable crc32 overflow bucket. Deterministic across
    restarts for the verbatim set AND the buckets (crc32, not
    ``hash``), so dashboards keyed on the label survive redeploys."""
    tenant = sanitize_tenant(tenant)
    with _label_lock:
        got = _label_claimed.get(tenant)
        if got is not None:
            return got
        if len(_label_claimed) < _label_max():
            _label_claimed[tenant] = tenant
            return tenant
    bucket = zlib.crc32(tenant.encode("utf-8")) % _N_BUCKETS
    return f"overflow-{bucket:02d}"


def reset_labels() -> None:
    """Drop the verbatim-label claims (tests only — production label
    identity is append-only by design)."""
    with _label_lock:
        _label_claimed.clear()


# -- wire descriptor ----------------------------------------------------

def encode_descriptor(tenant: str, priority_class: str) -> np.ndarray:
    """The optional PTST trailing tensor: uint8 bytes of
    ``tenant \\x00 class``. Callers append it to the generate body's
    tensor list; absence means default/standard."""
    tenant = sanitize_tenant(tenant)
    cls = normalize_class(priority_class)
    raw = tenant.encode("utf-8") + b"\x00" + cls.encode("utf-8")
    return np.frombuffer(raw, dtype=np.uint8).copy()


def decode_descriptor(arr: np.ndarray) -> Tuple[str, str]:
    """Inverse of :func:`encode_descriptor`; anything malformed
    degrades to ``(default, standard)`` rather than failing the
    request — tenancy is routing metadata, not payload."""
    try:
        raw = bytes(np.asarray(arr, dtype=np.uint8).reshape(-1))
        tenant_b, _, cls_b = raw.partition(b"\x00")
        return (sanitize_tenant(tenant_b.decode("utf-8")),
                normalize_class(cls_b.decode("utf-8")))
    except (ValueError, UnicodeDecodeError):
        return DEFAULT_TENANT, DEFAULT_CLASS
