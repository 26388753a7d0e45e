"""flag-freeze: flags are read at call time, never at module import (JAX:
``paddle_tpu/analysis/flag_freeze.py``).

``GLOBAL_FLAGS.get(...)`` at module scope freezes whatever the
environment held at *first import* — `FLAGS_*` env vars set afterwards
(tests, launchers exporting before spawn, `set_flags` at runtime)
silently never apply.  The whole point of the registry is late binding:
read the flag inside the function that needs it.

Deliberate import-time reads exist (arming the fault registry from an
env the drill exported before the trainer started) and carry inline
suppressions explaining exactly that.
"""

from __future__ import annotations

import ast

from .base import FUNC_NODES, Finding, Pass, flags_aliases


class FlagFreezePass(Pass):
    name = "flag-freeze"
    help = ("GLOBAL_FLAGS.get(...) at module import time freezes the "
            "env — read flags at call time")

    def run(self, modules, ctx):
        out = []
        for mod in modules:
            aliases = flags_aliases(mod.tree)
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if not (isinstance(f, ast.Attribute) and f.attr == "get"
                        and isinstance(f.value, ast.Name)
                        and f.value.id in aliases):
                    continue
                if mod.enclosing(node, FUNC_NODES + (ast.Lambda,)) \
                        is not None:
                    continue
                out.append(Finding(
                    self.name, mod.rel, node.lineno,
                    "flag read at module import time — the value "
                    "freezes whatever the env held at first import; "
                    "read the flag at call time (or suppress with the "
                    "reason the freeze is deliberate)"))
        return out

    positive = (
        """
        from paddle_tpu_torch.flags import GLOBAL_FLAGS

        _DEBUG = GLOBAL_FLAGS.get("debug_mode")
        """,
        # aliased import, read inside a module-scope try
        """
        from paddle_tpu_torch.flags import GLOBAL_FLAGS as _GF

        try:
            _SPEC = _GF.get("fault_spec")
        except Exception:
            _SPEC = None
        """,
    )
    negative = (
        # call-time read is the rule
        """
        from paddle_tpu_torch.flags import GLOBAL_FLAGS

        def debug_enabled():
            return bool(GLOBAL_FLAGS.get("debug_mode"))
        """,
        # method read is also call time
        """
        from paddle_tpu_torch.flags import GLOBAL_FLAGS as _GF

        class T:
            def tick(self):
                return _GF.get("interval")
        """,
    )
