"""silent-failure: `except …: pass` must be counted or justified (JAX:
``paddle_tpu/analysis/silent_failure.py``).

A bare ``pass`` handler makes a failure class invisible forever: shm
decode errors leak segments, close() errors hide socket trouble, and
nobody ever learns.  The rule: either the handler increments a counter
/ flight event (any non-``pass`` body), or the site carries a
suppression **with a reason** —

    except OSError:  # ptlint: disable=silent-failure -- <why it's safe>
        pass

Reason-less suppressions are rejected (``requires_reason``).
"""

from __future__ import annotations

import ast

from .base import Finding, Pass


class SilentFailurePass(Pass):
    name = "silent-failure"
    help = ("`except …: pass` swallows failures invisibly — count it "
            "(metrics/flight) or suppress with a reason")
    requires_reason = True

    def run(self, modules, ctx):
        out = []
        for mod in modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ExceptHandler) \
                        and len(node.body) == 1 \
                        and isinstance(node.body[0], ast.Pass):
                    out.append(Finding(
                        self.name, mod.rel, node.lineno,
                        "`except …: pass` swallows the failure "
                        "invisibly — increment a counter / flight "
                        "event, or suppress with a reason "
                        "(`# ptlint: disable=silent-failure -- <why>`)"))
        return out

    positive = (
        """
        def f():
            try:
                g()
            except ValueError:
                pass
        """,
        """
        def f():
            try:
                g()
            except Exception:  # noqa: BLE001
                pass
        """,
    )
    negative = (
        # counted through the data loader's helper (metric + flight)
        """
        def shutdown(qs):
            for q in qs:
                try:
                    q.put(None)
                except (OSError, ValueError) as e:
                    _note_swallowed("shutdown_put", e)
        """,
        # counted handler: the failure stays observable
        """
        def f(metrics):
            try:
                g()
            except Exception:
                metrics.counter("g_errors_total", "g failures").inc()
        """,
        # suppressed WITH a reason (the round-trip case)
        """
        def f():
            try:
                g()
            except OSError:  # ptlint: disable=silent-failure -- interpreter may be tearing down
                pass
        """,
    )
