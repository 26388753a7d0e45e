"""clock-hygiene: durations must come from monotonic clocks (JAX:
``paddle_tpu/analysis/clock_hygiene.py``).

``time.time()`` is wall time: NTP step adjustments move it backwards or
forwards by whole seconds, so any latency/age computed by subtracting
two wall stamps (TTFT, TPOT, queue wait, watchdog ages) can jump or go
negative under clock discipline that is entirely outside the process.
Durations belong to ``time.monotonic()`` / ``time.perf_counter()``.

The pass runs a small local taint analysis per scope: a name assigned
from ``time.time()`` (propagated through simple assignments, tuple
unpacks, ``or``/conditional expressions) and any ``self.<attr>``
assigned from ``time.time()`` anywhere in the file are *wall-tainted*;
a subtraction with a wall-tainted operand (or a direct ``time.time()``
operand) is a finding.  Deadline *comparisons* (``time.time() <
deadline``) and record-dict arithmetic over stored stamps
(``req["b"] - req["a"]``) are deliberately not flagged.

Realtime is still legal where wall time is the point — wire-ingress
stamps crossing process boundaries (``ingress_unix`` from csrc),
exported heartbeat gauges, test-pinned watchdog fields — and those
sites carry `# ptlint: disable=clock-hygiene -- <why>` suppressions or
baseline entries.
"""

from __future__ import annotations

import ast

from .base import FUNC_NODES, Finding, Pass
from .capturegraph import attr_chain


def _is_wall_call(node):
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    return chain == "time.time" or chain.endswith(".time.time")


def _scope_nodes(scope):
    """Nodes lexically in this scope, nested functions excluded (they
    get their own scan)."""
    out = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        if isinstance(n, FUNC_NODES):
            continue
        out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


class ClockHygienePass(Pass):
    name = "clock-hygiene"
    help = ("time.time() flowing into a duration subtraction — use "
            "time.monotonic()/perf_counter(); wall time only at "
            "allowlisted wire-ingress stamps")

    def run(self, modules, ctx):
        findings = []
        for mod in modules:
            tainted_attrs = self._tainted_attrs(mod)
            scopes = [mod.tree] + [n for n in ast.walk(mod.tree)
                                   if isinstance(n, FUNC_NODES)]
            for scope in scopes:
                findings.extend(
                    self._scan_scope(mod, scope, tainted_attrs))
        return findings

    @staticmethod
    def _tainted_attrs(mod):
        """self.<attr> names assigned from time.time() anywhere."""
        tainted = set()
        assigns = [n for n in ast.walk(mod.tree)
                   if isinstance(n, (ast.Assign, ast.AnnAssign))]
        for _ in range(4):
            changed = False
            for n in assigns:
                value = n.value
                if value is None:
                    continue
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    pairs = []
                    if isinstance(t, ast.Tuple) \
                            and isinstance(value, ast.Tuple) \
                            and len(t.elts) == len(value.elts):
                        pairs = list(zip(t.elts, value.elts))
                    else:
                        pairs = [(t, value)]
                    for tgt, val in pairs:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                                and tgt.attr not in tainted
                                and (_is_wall_call(val)
                                     or (isinstance(val, ast.Attribute)
                                         and isinstance(val.value,
                                                        ast.Name)
                                         and val.value.id == "self"
                                         and val.attr in tainted))):
                            tainted.add(tgt.attr)
                            changed = True
            if not changed:
                break
        return tainted

    def _scan_scope(self, mod, scope, tainted_attrs):
        nodes = _scope_nodes(scope)
        tainted = set()
        for _ in range(8):
            changed = False
            for n in nodes:
                if isinstance(n, ast.Assign):
                    items = [(t, n.value) for t in n.targets]
                elif isinstance(n, ast.AnnAssign) and n.value is not None:
                    items = [(n.target, n.value)]
                else:
                    continue
                for tgt, val in items:
                    pairs = []
                    if isinstance(tgt, ast.Tuple) \
                            and isinstance(val, ast.Tuple) \
                            and len(tgt.elts) == len(val.elts):
                        pairs = list(zip(tgt.elts, val.elts))
                    else:
                        pairs = [(tgt, val)]
                    for t2, v2 in pairs:
                        if isinstance(t2, ast.Name) \
                                and t2.id not in tainted \
                                and self._tainted_expr(v2, tainted,
                                                       tainted_attrs):
                            tainted.add(t2.id)
                            changed = True
            if not changed:
                break
        out = []
        for n in nodes:
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub):
                for side in (n.left, n.right):
                    if self._tainted_operand(side, tainted,
                                             tainted_attrs):
                        out.append(Finding(
                            self.name, mod.rel, n.lineno,
                            "wall-clock `time.time()` flows into a "
                            "duration subtraction — durations must use "
                            "time.monotonic()/time.perf_counter() (NTP "
                            "steps move wall time); realtime is only "
                            "legal at wire-ingress stamps (suppress "
                            "with a reason there)"))
                        break
        return out

    @classmethod
    def _tainted_operand(cls, node, tainted, tainted_attrs):
        if _is_wall_call(node):
            return True
        if isinstance(node, ast.Name) and node.id in tainted:
            return True
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in tainted_attrs):
            return True
        return False

    @classmethod
    def _tainted_expr(cls, node, tainted, tainted_attrs):
        if cls._tainted_operand(node, tainted, tainted_attrs):
            return True
        if isinstance(node, ast.BoolOp):
            return any(cls._tainted_expr(v, tainted, tainted_attrs)
                       for v in node.values)
        if isinstance(node, ast.IfExp):
            return (cls._tainted_expr(node.body, tainted, tainted_attrs)
                    or cls._tainted_expr(node.orelse, tainted,
                                         tainted_attrs))
        return False

    positive = (
        # the classic pair
        """
        import time

        def work():
            t0 = time.time()
            do_stuff()
            return time.time() - t0
        """,
        # wall stamp stored on self, subtracted in another method
        """
        import time

        class T:
            def start(self):
                self._t0 = time.time()

            def lap(self):
                now = time.time()
                return now - self._t0
        """,
        # the serving engine's watchdog age over its wall step stamps
        """
        import time

        class Engine:
            def step(self):
                self._step_end_unix = time.time()

            def health(self):
                now = time.time()
                stamps = [x for x in (self._step_end_unix,)
                          if x is not None]
                return max(0.0, now - max(stamps)) if stamps else None
        """,
    )
    negative = (
        # monotonic pair is the fix
        """
        import time

        def work():
            t0 = time.monotonic()
            do_stuff()
            return time.monotonic() - t0
        """,
        # deadline comparison and additive deadline are fine
        """
        import time

        def wait(grace_s):
            deadline = time.time() + grace_s
            while time.time() < deadline:
                pass
        """,
        # record-dict math over stored stamps is untainted by design
        """
        def span(req):
            return (req["dispatch_unix"] - req["ingress_unix"]) * 1e3
        """,
    )
