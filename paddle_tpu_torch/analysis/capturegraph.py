"""Capture-root discovery and same-module call-graph walking (JAX:
``paddle_tpu/analysis/jitgraph.py``).

The port's counterpart of tracing is CUDA-graph capture: a graph records
the device work of one run of a Python body, and a replay runs none of
that Python again.  Used by the capture-purity pass.  The model is
jitgraph's, deliberately lexical and same-module only:

- **roots** are
  - the ``body`` handed to ``static._capture(owner, graph, body, …)``,
    as the third positional argument or as ``body=``;
  - the callable handed to a backend's ``.capture(fn, …)``, as the first
    positional argument or as ``fn=``;
  - the statements inside a ``with torch.cuda.graph(…):`` block (its
    with-items run before the capture begins, so they are not part of
    it).

  A root expression resolves as jitgraph's does: one level of wrapper
  call unwrapped (``functools.partial``), a lambda kept, a bare name to
  every same-module ``def`` of that name, ``self.m`` to the method of
  the enclosing class.
- **edges** resolve bare-name calls to same-module ``def``s (any
  nesting level; if several defs share the name, all are traversed —
  conservative) and ``self.m()`` calls to methods of the enclosing
  class, so a ``body`` nested in a method reaches that class's
  ``self._step``.  Cross-module calls (the model's forward, the
  optimizer's update, the kernel wrappers) are out of scope, as in
  jitgraph: a known heuristic limit.
- Unlike jitgraph there is no callback allowlist: a CUDA graph has no
  host callback, so nothing under a root is exempt.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from .base import FUNC_NODES

WITH_NODES = (ast.With, ast.AsyncWith)


def attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute chain rooted at a Name, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def is_graph_block(node: ast.AST) -> bool:
    """``node`` is a ``with torch.cuda.graph(…):`` statement."""
    if not isinstance(node, WITH_NODES):
        return False
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            chain = attr_chain(expr.func)
            if chain == "cuda.graph" or chain.endswith(".cuda.graph"):
                return True
    return False


def root_name(fn: ast.AST) -> str:
    if isinstance(fn, WITH_NODES):
        return "<captured block>"
    return getattr(fn, "name", "<lambda>")


def iter_scope(fn: ast.AST):
    """Nodes lexically in ``fn``'s own executed scope: nested ``def``s
    are skipped (they run only when called — the graph walks them as
    separate functions).  Lambda bodies are kept.  For a captured
    ``with`` block, only the statements of its body."""
    if isinstance(fn, WITH_NODES):
        stack = list(fn.body)
    else:
        stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, FUNC_NODES):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _argument(call: ast.Call, index: int, keyword: str):
    if len(call.args) > index:
        return call.args[index]
    for kw in call.keywords:
        if kw.arg == keyword:
            return kw.value
    return None


class ModuleGraph:
    """Function index + capture-root discovery for one SourceModule."""

    def __init__(self, mod):
        self.mod = mod
        self.defs: Dict[str, List[ast.AST]] = {}
        self.methods: Dict[Tuple[str, str], ast.AST] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, FUNC_NODES):
                self.defs.setdefault(node.name, []).append(node)
                cls = mod.enclosing(node, (ast.ClassDef,))
                if cls is not None:
                    self.methods.setdefault((cls.name, node.name), node)

    def enclosing_class_name(self, node: ast.AST):
        cls = self.mod.enclosing(node, (ast.ClassDef,))
        return cls.name if cls is not None else None

    def resolve_target(self, expr: ast.AST, class_name) -> List[ast.AST]:
        """Resolve an expression handed to a capture to local function
        defs (unwraps one wrapper-call level for partial shapes)."""
        if isinstance(expr, ast.Call):
            if expr.args:
                return self.resolve_target(expr.args[0], class_name)
            return []
        if isinstance(expr, ast.Lambda):
            return [expr]
        if isinstance(expr, ast.Name):
            return list(self.defs.get(expr.id, ()))
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and class_name):
            m = self.methods.get((class_name, expr.attr))
            return [m] if m is not None else []
        return []

    def resolve_call(self, call: ast.Call, class_name) -> List[ast.AST]:
        """Same-module callees of a direct call (no wrapper unwrap)."""
        f = call.func
        if isinstance(f, ast.Name):
            return list(self.defs.get(f.id, ()))
        if (isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self" and class_name):
            m = self.methods.get((class_name, f.attr))
            return [m] if m is not None else []
        return []

    def capture_roots(self) -> List[Tuple[ast.AST, str]]:
        """[(fn_or_with_node, description)] for every captured body; a
        body that several roots reach is described by its
        ``_capture(…)`` call where it has one (the caller's site), not by
        the backend call ``_capture`` makes."""
        roots: List[Tuple[int, ast.AST, str]] = []
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Call):
                f = node.func
                chain = attr_chain(f)
                name = f.id if isinstance(f, ast.Name) else \
                    f.attr if isinstance(f, ast.Attribute) else ""
                if name == "_capture":
                    target = _argument(node, 2, "body")
                elif name == "capture" and isinstance(f, ast.Attribute):
                    target = _argument(node, 0, "fn")
                else:
                    continue
                if target is None:
                    continue
                cls = self.enclosing_class_name(node)
                label = chain or f".{name}"
                rank = 0 if name == "_capture" else 1
                for fn in self.resolve_target(target, cls):
                    roots.append((rank, fn,
                                  f"`{label}(…)` at line {node.lineno}"))
            elif is_graph_block(node):
                roots.append((2, node, "`with torch.cuda.graph(…)` at "
                                       f"line {node.lineno}"))
        roots.sort(key=lambda r: r[0])
        seen, out = set(), []
        for _, fn, desc in roots:
            if id(fn) not in seen:
                seen.add(id(fn))
                out.append((fn, desc))
        return out

    def reachable(self, roots) -> Dict[int, Tuple[ast.AST, str]]:
        """{id(fn): (fn, root_description)} over same-module edges."""
        out: Dict[int, Tuple[ast.AST, str]] = {}
        stack = list(roots)
        while stack:
            fn, desc = stack.pop()
            if id(fn) in out:
                continue
            out[id(fn)] = (fn, desc)
            cls = self.enclosing_class_name(fn)
            for node in iter_scope(fn):
                if isinstance(node, ast.Call):
                    for callee in self.resolve_call(node, cls):
                        if id(callee) not in out:
                            stack.append((callee, desc))
        return out
