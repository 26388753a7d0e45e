"""metric-hygiene: instrument kinds must match their naming contract (JAX:
``paddle_tpu/analysis/metric_hygiene.py``).

The registry's naming conventions are load-bearing, not cosmetic: the
SLO engine treats ``*_total`` as monotonic counters (windowed
``increase()`` reset-clamps them), the fleet merge sums them across
hosts, and ``*_ms`` histograms are only bucket-wise mergeable — and
their SLO thresholds only exact — when every host declares the shared
``LATENCY_MS_BUCKETS`` boundaries.  This pass pins those contracts at
the registration site:

- a literal name ending ``_total`` must be registered with
  ``counter(...)`` — a gauge or histogram under that suffix would be
  silently mis-merged (summed as if monotonic) and mis-windowed;
- a literal name ending ``_ms`` registered with ``histogram(...)``
  must declare ``buckets=<…>LATENCY_MS_BUCKETS`` — defaulted
  boundaries (seconds-scale) put every millisecond sample in +Inf and
  break the cross-host merge the moment two sites disagree;
- a ``gauge(...)`` registration must not be used add/inc-only: a
  value that only ever accumulates is a counter (``inc()`` is not
  even in the Gauge API and fails at runtime); ``add()`` is legal
  only for gauges the same module also ``set()``/``set_max()``s.

Only string-literal names are judged — dynamically built names are a
different rule's problem (metrics-doc already forces literals into the
docs).  ``selftest_``-prefixed names are exempt: drill fixtures
deliberately fabricate odd instruments.
"""

from __future__ import annotations

import ast

from .base import Finding, Pass
from .capturegraph import attr_chain

_REGISTER_FUNCS = ("counter", "gauge", "histogram")


def _registration(node):
    """(kind, name, call) when ``node`` registers an instrument with a
    literal name: a call whose callee is ``counter``/``gauge``/
    ``histogram`` (bare or as the terminal attribute, catching
    ``obs.X`` / ``_metrics.X`` / ``registry().X``)."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Name):
        kind = func.id
    elif isinstance(func, ast.Attribute):
        kind = func.attr
    else:
        return None
    if kind not in _REGISTER_FUNCS:
        return None
    if not (node.args and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return None
    name = node.args[0].value
    if name.startswith("selftest_"):
        return None
    return kind, name, node


def _buckets_kwarg(call):
    for kw in call.keywords:
        if kw.arg == "buckets":
            return kw.value
    return None


class MetricHygienePass(Pass):
    name = "metric-hygiene"
    help = ("instrument kind must match the name contract: *_total is "
            "a counter, *_ms histograms declare LATENCY_MS_BUCKETS, "
            "gauges are not add/inc-only")

    def run(self, modules, ctx):
        findings = []
        for mod in modules:
            findings.extend(self._scan(mod))
        return findings

    def _scan(self, mod):
        out = []
        # gauge usage survey first: which literal gauge names does this
        # module ever level-set vs only accumulate?
        gauge_setters, gauge_adders = set(), {}
        for n in ast.walk(mod.tree):
            if not (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Call)):
                continue
            reg = _registration(n.value)
            if reg is None or reg[0] != "gauge":
                continue
            if n.attr in ("set", "set_max"):
                gauge_setters.add(reg[1])
            elif n.attr in ("add", "inc"):
                gauge_adders.setdefault(reg[1], (n.value.lineno, n.attr))

        for n in ast.walk(mod.tree):
            reg = _registration(n)
            if reg is None:
                continue
            kind, name, call = reg
            if name.endswith("_total") and kind != "counter":
                out.append(Finding(
                    self.name, mod.rel, call.lineno,
                    f"`{name}` registered as a {kind} — the *_total "
                    "suffix promises a monotonic counter (SLO windowed "
                    "increase() and the fleet sum-merge rely on it); "
                    "rename it or register a counter"))
            if kind == "histogram" and name.endswith("_ms"):
                b = _buckets_kwarg(call)
                bucket_src = attr_chain(b) if b is not None else ""
                if not bucket_src.endswith("LATENCY_MS_BUCKETS"):
                    out.append(Finding(
                        self.name, mod.rel, call.lineno,
                        f"`{name}` histogram must declare "
                        "buckets=…LATENCY_MS_BUCKETS — default "
                        "boundaries are seconds-scale (every ms sample "
                        "lands in +Inf) and mismatched boundaries "
                        "break the fleet bucket-wise merge and exact "
                        "SLO thresholds"))
        for name, (lineno, meth) in sorted(gauge_adders.items()):
            if meth == "inc" or name not in gauge_setters:
                out.append(Finding(
                    self.name, mod.rel, lineno,
                    f"gauge `{name}` is {meth}()-only here — a value "
                    "that only accumulates is a counter (and Gauge has "
                    "no inc()); use counter(), or pair add() with a "
                    "set()/set_max() site in this module"))
        return out

    positive = (
        # *_total as a gauge
        """
        from paddle_tpu_torch import observability as obs

        def publish(n):
            obs.gauge("worker_restarts_total", "h").set(n)
        """,
        # *_total as a histogram
        """
        from paddle_tpu_torch.observability import metrics as _m

        def publish(v):
            _m.histogram("frames_dropped_total", "h").observe(v)
        """,
        # _ms histogram without the shared boundaries
        """
        from paddle_tpu_torch import observability as obs

        def note(ms):
            obs.histogram("queue_wait_ms", "h").observe(ms)
        """,
        # _ms histogram with ad-hoc boundaries
        """
        from paddle_tpu_torch import observability as obs

        MY_BUCKETS = (1.0, 10.0)

        def note(ms):
            obs.histogram("queue_wait_ms", "h",
                          buckets=MY_BUCKETS).observe(ms)
        """,
        # add()-only gauge: that's a counter in disguise
        """
        from paddle_tpu_torch import observability as obs

        def bump():
            obs.gauge("bytes_seen", "h").add(4096)
        """,
    )
    negative = (
        # the contract followed: counter for _total, shared buckets
        """
        from paddle_tpu_torch.observability import metrics as _m

        def note(ms):
            _m.counter("frames_total", "h").inc()
            _m.histogram("queue_wait_ms", "h",
                         buckets=_m.LATENCY_MS_BUCKETS).observe(ms)
        """,
        # add() is fine when the module also level-sets the gauge
        """
        from paddle_tpu_torch import observability as obs

        def drain(n):
            obs.gauge("inflight", "h").add(-n)

        def reset():
            obs.gauge("inflight", "h").set(0.0)
        """,
        # selftest_ fixtures and dynamic names are exempt
        """
        from paddle_tpu_torch import observability as obs

        def fabricate(name):
            obs.gauge("selftest_weird_total", "h").set(1.0)
            obs.histogram(name + "_ms", "h").observe(1.0)
        """,
    )
