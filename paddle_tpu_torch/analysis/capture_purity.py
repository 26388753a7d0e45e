"""capture-purity: host effects must not reach a captured CUDA graph
(JAX: ``paddle_tpu/analysis/trace_purity.py``).

A function reachable from a capture root (the ``body`` that
``static._capture`` records, a backend's ``.capture(fn)``, a ``with
torch.cuda.graph(…):`` block; ``capturegraph`` finds them) runs its
Python **once, at capture**.  A replay repeats only the device work, so:

- a clock, ``random`` / ``np.random``, ``os.environ`` or flag read there
  bakes one host value into every replay;
- a metric registration, a flight-recorder write, a ``global`` /
  ``nonlocal`` write or a write to ``self.<attr>`` happens once instead
  of once per step;
- a host sync (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``) cannot be recorded at all.

The first two are trace-purity's effect set; the last two are the
capture's own.  A host value that deliberately joins the graph's key
(the step's signature, so a new value captures a new graph) is legal
with ``# ptlint: disable=capture-purity -- <reason>`` naming the key
line; an in-place device write (``t.add_(…)``, ``t.fill_(…)``) is
recorded by the capture and is no effect.
"""

from __future__ import annotations

import ast
import re

from .base import Finding, Pass, flags_aliases
from .capturegraph import ModuleGraph, attr_chain, iter_scope, root_name

_ENV_CALLS = {"os.getenv", "os.environ.get", "os.putenv"}
_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
_HOST_SYNCS = {"item", "tolist", "cpu", "numpy"}
#: every capture root's source holds one of these; a module without any
#: is skipped before its call graph is indexed
_ROOT_TEXT = re.compile(r"capture\s*\(|\.graph\s*\(")


def _self_attr_targets(node):
    """``self.<attr>`` names an assignment, augmented assignment or
    ``del`` writes (through tuple/list/starred targets)."""
    if isinstance(node, (ast.Assign, ast.Delete)):
        stack = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        stack = [node.target]
    else:
        return []
    out = []
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        elif (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
              and t.value.id == "self"):
            out.append(t.attr)
    return out


def _effects(fn, aliases):
    """[(lineno, description)] host effects lexically in fn's scope."""
    out = []
    for node in iter_scope(fn):
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            kind = "global" if isinstance(node, ast.Global) else "nonlocal"
            out.append((node.lineno,
                        f"`{kind} {', '.join(node.names)}` write"))
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                               ast.Delete)):
            for attr in _self_attr_targets(node):
                out.append((node.lineno, f"`self.{attr}` write"))
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _HOST_SYNCS:
                out.append((node.lineno, f"`.{f.attr}()` host sync"))
                continue
            chain = attr_chain(f)
            if not chain:
                continue
            parts = chain.split(".")
            root, last = parts[0], parts[-1]
            if chain == "cuda.synchronize" \
                    or chain.endswith(".cuda.synchronize"):
                out.append((node.lineno, f"`{chain}()` host sync"))
            elif root in ("time", "_time"):
                out.append((node.lineno, f"`{chain}()` host clock read"))
            elif root == "random" or chain.startswith(("np.random.",
                                                       "numpy.random.")):
                out.append((node.lineno, f"`{chain}()` host RNG"))
            elif chain in _ENV_CALLS:
                out.append((node.lineno, f"`{chain}()` environment read"))
            elif last == "get" and any(
                    "FLAGS" in p or p in aliases for p in parts[:-1]):
                out.append((node.lineno, f"`{chain}()` flag read"))
            elif (last in _METRIC_FACTORIES and len(parts) <= 2
                  and root not in ("self", "cls")):
                out.append((node.lineno,
                            f"`{chain}()` metric registration/mutation"))
            elif (last == "record" and len(parts) >= 2
                  and "flight" in parts[-2].lower()):
                out.append((node.lineno,
                            f"`{chain}()` flight-recorder write"))
        elif isinstance(node, ast.Attribute):
            if (node.attr == "environ" and isinstance(node.value, ast.Name)
                    and node.value.id == "os"):
                out.append((node.lineno, "`os.environ` access"))
    return out


class CapturePurityPass(Pass):
    name = "capture-purity"
    help = ("host effects (time/random/os.environ/flag reads/metric "
            "writes/global and self.<attr> writes/host syncs) in "
            "functions reachable from CUDA-graph capture roots")

    def run(self, modules, ctx):
        findings = []
        for mod in modules:
            if not _ROOT_TEXT.search(mod.text):
                continue
            graph = ModuleGraph(mod)
            roots = graph.capture_roots()
            if not roots:
                continue
            aliases = flags_aliases(mod.tree)
            seen = set()
            for fn, desc in graph.reachable(roots).values():
                for lineno, what in _effects(fn, aliases):
                    key = (lineno, what)
                    if key in seen:
                        continue
                    seen.add(key)
                    findings.append(Finding(
                        self.name, mod.rel, lineno,
                        f"host effect {what} in `{root_name(fn)}`, "
                        f"reachable from capture root {desc} — a replay "
                        "runs none of the captured Python: a host value "
                        "read there is baked in at capture, a side "
                        "effect happens once, and a host sync cannot be "
                        "recorded"))
        return findings

    positive = (
        # a clock read in the step that the captured body calls
        """
        import time
        from paddle_tpu_torch.static import _capture

        class Step:
            def _step(self, x):
                t = time.time()
                return x * t

            def _run(self, graph, x):
                def body():
                    graph.outputs = self._step(x)

                _capture(self, graph, body)
        """,
        # a host sync in a helper the captured step calls
        """
        from paddle_tpu_torch.static import _capture

        def _norm(g):
            return g.norm().item()

        def step(x):
            return x / _norm(x)

        def run(owner, graph, x):
            _capture(owner, graph, body=lambda: step(x))
        """,
        # a host counter bumped in the body: replays never bump it
        """
        from paddle_tpu_torch.static import _capture

        class Step:
            def _capture(self, graph, x):
                def body():
                    self.calls += 1
                    graph.outputs = x * 2

                _capture(self, graph, body)
        """,
        # Python RNG inside a with-graph block
        """
        import random
        import torch

        def record(g, x):
            with torch.cuda.graph(g):
                y = x * random.random()
            return y
        """,
        # a flag read in the callable a backend's capture records
        """
        from paddle_tpu_torch.flags import GLOBAL_FLAGS

        def step(x):
            if GLOBAL_FLAGS.get("skip_nonfinite_steps"):
                return x
            return x * 2

        def record(backend, x):
            return backend.capture(step)
        """,
    )
    negative = (
        # the same effects only in the eager warm-up and the host side
        """
        import random
        import time
        from paddle_tpu_torch.static import _capture

        class Step:
            def _lr(self):
                self.lr_scale = random.random()
                return time.time()

            def _step(self, x, lr):
                return x * lr

            def _run(self, graph, x):
                self.calls += 1
                lr = self._lr()
                warm = self._backend.warm_up(lambda: self._step(x, lr))
                loss = warm.item()

                def body():
                    graph.outputs = self._step(x, lr)

                _capture(self, graph, body)
                return loss
        """,
        # a read that joins the capture key, suppressed with its reason
        """
        from paddle_tpu_torch.flags import GLOBAL_FLAGS
        from paddle_tpu_torch.static import _capture

        class Step:
            def _step(self, x):
                # ptlint: disable=capture-purity -- joins the capture key (GLOBAL_FLAGS.snapshot() in _run's key)
                if GLOBAL_FLAGS.get("skip_nonfinite_steps"):
                    return x
                return x * 2

            def _run(self, graph, x):
                def body():
                    graph.outputs = self._step(x)

                _capture(self, graph, body)
        """,
        # in-place device writes are captured; with-items run before
        """
        import time
        import torch

        class Step:
            def record(self, g, x):
                with torch.cuda.graph(g, stream=self.pick(time.time())):
                    self.count.add_(x.sum())
                    self.scale.fill_(2.0)
        """,
    )
