"""lock-discipline: annotated fields only mutate under their lock (JAX:
``paddle_tpu/analysis/lock_discipline.py``).

The serving plane spans ~10 threads (batcher, stream bridge, metric
reporter, watchdogs, HTTP handlers) whose discipline used to live only
in comments.  This pass makes those comments checkable:

- ``# guarded-by: <lockexpr>`` on a field's init line (or the line
  directly above) declares that every mutation of the field must be
  lexically inside ``with <lockexpr>:`` — or in ``__init__``, or in a
  method annotated ``# holds-lock: <lockexpr>`` (callers acquire it).
  Works for ``self._field`` class fields and module globals.
- ``# guarded-by: single-owner (<who>)`` declares a lock-free
  single-thread ownership contract instead: the declaring class may
  mutate the field freely, but any ``obj.<field>`` mutation from
  outside (a non-``self`` receiver, anywhere in the scanned tree) is a
  violation.

Mutations are assignments (incl. tuple/subscript targets and
augmented assigns), ``del``, and calls of mutating container methods
(``append``/``pop``/``update``/…).  Lock expressions match textually
against ``ast.unparse`` of the with-items, so write the annotation the
way the code writes the ``with`` (e.g. ``self._lock``).
"""

from __future__ import annotations

import ast
import re

from .base import FUNC_NODES, Finding, Pass

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([^#]+?)\s*$")
_HOLDS_RE = re.compile(r"#\s*holds-lock:\s*([^#]+?)\s*$")

_MUTATORS = {
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "sort", "reverse",
}


def _assign_targets(node):
    out = []
    if isinstance(node, ast.Assign):
        raw = list(node.targets)
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        raw = [node.target]
    elif isinstance(node, ast.Delete):
        raw = list(node.targets)
    else:
        return out
    stack = raw
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        else:
            out.append(t)
    return out


def _mutated_slots(node):
    """Expressions whose binding/content this statement mutates."""
    slots = []
    for t in _assign_targets(node):
        if isinstance(t, ast.Subscript):
            slots.append(t.value)
        elif isinstance(t, (ast.Attribute, ast.Name)):
            slots.append(t)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        slots.append(node.func.value)
    return slots


def _declarations(mod):
    """[(class_name|None, field|None, lock, anno_lineno)] — a None
    field marks a dangling annotation."""
    assigns = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            assigns.setdefault(node.lineno, node)
    decls = []
    for i, comment in sorted(mod.comments.items()):
        m = _GUARD_RE.search(comment)
        if not m:
            continue
        lock = m.group(1).strip()
        # a comment-only line annotates the line below it
        own_line = mod.line(i).strip().startswith("#")
        target_line = i + 1 if own_line else i
        node = assigns.get(target_line)
        attached = False
        if node is not None:
            cls = mod.enclosing(node, (ast.ClassDef,))
            for t in _assign_targets(node):
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self" and cls is not None):
                    decls.append((cls.name, t.attr, lock, i))
                    attached = True
                elif (isinstance(t, ast.Name)
                      and mod.enclosing(node, FUNC_NODES) is None):
                    decls.append((None, t.id, lock, i))
                    attached = True
        if not attached:
            decls.append((None, None, lock, i))
    return decls


def _holds_lock(mod, fn, lock):
    for ln in (fn.lineno, fn.lineno - 1):
        m = _HOLDS_RE.search(mod.comments.get(ln, ""))
        if m and m.group(1).strip() == lock:
            return True
    return False


def _under_with(mod, node, lock):
    n = mod.parents.get(node)
    while n is not None:
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                try:
                    expr = ast.unparse(item.context_expr)
                except Exception:  # pragma: no cover
                    expr = ""
                if expr == lock:
                    return True
        n = mod.parents.get(n)
    return False


class LockDisciplinePass(Pass):
    name = "lock-discipline"
    help = ("fields annotated `# guarded-by: <lock>` mutate only under "
            "`with <lock>:` (or __init__/holds-lock); single-owner "
            "fields reject external mutation")

    def run(self, modules, ctx):
        findings = []
        per_mod = {}
        single_owner = {}  # field -> (class, rel, lock)
        for mod in modules:
            decls = _declarations(mod)
            per_mod[mod.rel] = decls
            for cls, field, lock, lineno in decls:
                if field is None:
                    findings.append(Finding(
                        self.name, mod.rel, lineno,
                        f"`# guarded-by: {lock}` is not attached to a "
                        "field assignment — put it on the field's init "
                        "line or the line directly above"))
                elif cls is not None and lock.startswith("single-owner"):
                    single_owner[field] = (cls, mod.rel, lock)

        for mod in modules:
            fields = {}
            globals_map = {}
            for cls, field, lock, _ in per_mod[mod.rel]:
                if field is None:
                    continue
                if cls is None:
                    globals_map[field] = lock
                else:
                    fields[(cls, field)] = lock
            for node in ast.walk(mod.tree):
                for slot in _mutated_slots(node):
                    findings.extend(self._check_slot(
                        mod, node, slot, fields, globals_map,
                        single_owner))
        return findings

    def _check_slot(self, mod, node, slot, fields, globals_map,
                    single_owner):
        out = []
        if isinstance(slot, ast.Attribute) \
                and isinstance(slot.value, ast.Name):
            field = slot.attr
            if slot.value.id == "self":
                cls = mod.enclosing(node, (ast.ClassDef,))
                if cls is None:
                    return out
                lock = fields.get((cls.name, field))
                if lock is None or lock.startswith("single-owner"):
                    return out  # single-owner: own-class mutation is fine
                if not self._legal(mod, node, lock):
                    out.append(Finding(
                        self.name, mod.rel, node.lineno,
                        f"`self.{field}` is declared `# guarded-by: "
                        f"{lock}` but is mutated outside `with {lock}:` "
                        "(and outside __init__) — take the lock, or "
                        f"annotate the method `# holds-lock: {lock}` if "
                        "every caller already holds it"))
            else:
                owner = single_owner.get(field)
                if owner is not None:
                    cls, rel, lock = owner
                    out.append(Finding(
                        self.name, mod.rel, node.lineno,
                        f"`.{field}` is declared `# guarded-by: {lock}` "
                        f"by {cls} ({rel}) — mutating it through an "
                        "external reference breaks the single-thread "
                        "ownership contract"))
        elif isinstance(slot, ast.Name):
            lock = globals_map.get(slot.id)
            if lock is None:
                return out
            if mod.enclosing(node, FUNC_NODES) is None:
                return out  # module-scope init (the declaration itself)
            if not self._legal(mod, node, lock, allow_init=False):
                out.append(Finding(
                    self.name, mod.rel, node.lineno,
                    f"module global `{slot.id}` is declared "
                    f"`# guarded-by: {lock}` but is mutated outside "
                    f"`with {lock}:`"))
        return out

    @staticmethod
    def _legal(mod, node, lock, allow_init=True):
        fn = mod.enclosing(node, FUNC_NODES)
        if fn is not None:
            if allow_init and fn.name == "__init__":
                return True
            if _holds_lock(mod, fn, lock):
                return True
        return _under_with(mod, node, lock)

    positive = (
        # class field mutated without the lock
        """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = []  # guarded-by: self._lock

            def bad(self, x):
                self._q.append(x)
        """,
        # module global mutated without the lock
        """
        import threading

        _lock = threading.Lock()
        _server = None  # guarded-by: _lock

        def stop():
            global _server
            _server = None
        """,
        # single-owner field mutated through an external reference
        """
        class E:
            def __init__(self):
                self._seqs = {}  # guarded-by: single-owner (serving thread)

        class Other:
            def poke(self, e):
                e._seqs["x"] = 1
        """,
    )
    negative = (
        # every mutation under the lock (incl. subscript + del)
        """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._q = {}  # guarded-by: self._lock

            def good(self, k, v):
                with self._lock:
                    self._q[k] = v
                    del self._q[k]
        """,
        # caller holds the lock; callee declares holds-lock
        """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0  # guarded-by: self._lock

            def _bump(self):  # holds-lock: self._lock
                self._n += 1

            def bump(self):
                with self._lock:
                    self._bump()
        """,
        # single-owner class mutating its own field is fine
        """
        class E:
            def __init__(self):
                self._seqs = {}  # guarded-by: single-owner (serving thread)

            def emit(self, k, v):
                self._seqs[k] = v
                self._seqs.pop(k, None)
        """,
    )
