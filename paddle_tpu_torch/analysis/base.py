"""ptlint core of the port (JAX: ``paddle_tpu/analysis/base.py``).

The pass-based static analysis of ``paddle_tpu_torch/``: a registry of
small, composable passes that walk the Python sources (and a little of
``csrc/``) without importing the framework.  Everything in
``paddle_tpu_torch/analysis/`` stays **stdlib-only**
(ast/json/os/re/textwrap/tokenize), so ``ptlint.py`` runs in
milliseconds with no torch.

Shared pieces:

- :class:`Finding` — one diagnostic: rule id, ``path:line``, severity.
- :class:`SourceModule` — one parsed file (parse once, share across
  every pass), with raw source lines kept so passes can read comments
  (``# guarded-by:``, ``# ptlint: disable=``) that ast discards.
- suppressions — ``# ptlint: disable=<rule>[,<rule>…] -- <reason>`` on
  the finding line or the line directly above.  Passes with
  ``requires_reason = True`` reject reason-less suppressions.  The
  syntax is the JAX package's, so one annotation means the same to both
  linters.
- baseline — ``paddle_tpu_torch/analysis/ptlint_baseline.json`` holds
  deliberately deferred findings, each with a reason, in the JAX
  baseline's format.  Entries are matched by (rule, path,
  stripped-source-line anchor) so they survive line drift; an entry
  that matches nothing is *stale* and errors, which is how the
  "baseline may only shrink" policy is enforced at runtime.

docs/static_analysis.md holds the rule catalog and policies.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import textwrap
import tokenize
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: repo root (…/paddle_tpu_torch/analysis/base.py -> repo)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

_SUPPRESS_RE = re.compile(
    r"#\s*ptlint:\s*disable=\s*([A-Za-z0-9_,\-]+)"
    r"(?:\s+--\s*(\S.*?))?\s*$")


# ---------------------------------------------------------------------------
# findings and suppressions
# ---------------------------------------------------------------------------


@dataclass
class Finding:
    """One diagnostic, anchored at ``path:line``."""

    rule: str
    path: str            # repo-relative, '/'-separated
    line: int
    message: str
    severity: str = "error"

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Suppression:
    """A parsed ``# ptlint: disable=…`` comment."""

    line: int
    rules: Tuple[str, ...]
    reason: str


def comment_lines(text: str) -> Dict[int, str]:
    """{lineno: comment_text} for real COMMENT tokens only — a
    ``# guarded-by:`` inside a docstring or string literal is prose,
    not an annotation."""
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError,
            SyntaxError):  # pragma: no cover - ast.parse catches first
        for i, line in enumerate(text.splitlines(), 1):
            if line.lstrip().startswith("#"):
                out[i] = line.strip()
    return out


def parse_suppressions(comments: Dict[int, str]) -> List[Suppression]:
    out = []
    for i, comment in sorted(comments.items()):
        m = _SUPPRESS_RE.search(comment)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            out.append(Suppression(i, rules, (m.group(2) or "").strip()))
    return out


# ---------------------------------------------------------------------------
# source modules
# ---------------------------------------------------------------------------


class SourceModule:
    """One parsed source file, shared by every pass (parse once)."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.comments = comment_lines(text)
        self.suppressions = parse_suppressions(self.comments)
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    @classmethod
    def from_source(cls, source: str, rel: str = "fixture.py"):
        return cls("<fixture>", rel, textwrap.dedent(source))

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppression_for(self, rule: str, lineno: int):
        """The suppression covering (rule, line), if any — same line or
        the line directly above."""
        for s in self.suppressions:
            if rule in s.rules and s.line in (lineno, lineno - 1):
                return s
        return None

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            p: Dict[ast.AST, ast.AST] = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    p[child] = node
            self._parents = p
        return self._parents

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        """Nearest ancestor of ``node`` matching ``kinds`` (or None)."""
        n = self.parents.get(node)
        while n is not None:
            if isinstance(n, kinds):
                return n
            n = self.parents.get(n)
        return None


EXCLUDE_DIRS = {"__pycache__", ".git", "build", "dist", ".eggs"}


def load_modules(root: str,
                 subdirs: Sequence[str] = ("paddle_tpu_torch",),
                 on_error=None) -> List[SourceModule]:
    """Parse every ``.py`` under ``root/<subdir>`` (or a single file)."""
    mods: List[SourceModule] = []
    for sub in subdirs:
        top = os.path.join(root, sub)
        if os.path.isfile(top):
            paths = [top] if top.endswith(".py") else []
        else:
            paths = []
            for dirpath, dirnames, files in os.walk(top):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in EXCLUDE_DIRS)
                paths.extend(os.path.join(dirpath, f)
                             for f in sorted(files) if f.endswith(".py"))
        for path in paths:
            try:
                with open(path) as fh:
                    text = fh.read()
                mods.append(SourceModule(
                    path, os.path.relpath(path, root), text))
            except (OSError, SyntaxError) as e:
                if on_error is not None:
                    on_error(path, e)
    return mods


# ---------------------------------------------------------------------------
# pass base + fixture self-test
# ---------------------------------------------------------------------------


@dataclass
class Context:
    """Ambient inputs a pass may need beyond the parsed modules.

    ``root`` is None for fixture runs; doc passes take the text
    overrides so their self-tests need no filesystem."""

    root: Optional[str] = None
    docs_text: Optional[str] = None        # flags-doc override
    metrics_doc_text: Optional[str] = None  # metrics-doc override


class Pass:
    """Base class for ptlint passes.

    Subclasses set ``name`` (the rule id used in suppressions and the
    baseline), ``help`` (one-line catalog entry), optionally
    ``requires_reason`` (suppressions must carry ``-- <why>``), and the
    ``positive`` / ``negative`` fixture snippets the self-test runs."""

    name = "?"
    help = ""
    severity = "error"
    requires_reason = False
    #: rel path given to fixture modules (doc passes need a specific one)
    fixture_rel: Optional[str] = None
    positive: Sequence[str] = ()
    negative: Sequence[str] = ()

    def run(self, modules: List[SourceModule],
            ctx: Context) -> List[Finding]:
        raise NotImplementedError

    def self_test(self) -> List[str]:
        """Error strings ([] = healthy).  Default: every positive
        fixture must produce ≥1 unsuppressed finding, every negative
        fixture none."""
        return fixture_self_test(self)


def fixture_self_test(p: Pass, ctx: Optional[Context] = None) -> List[str]:
    ctx = ctx or Context(root=None)
    errs = []
    if not p.positive or not p.negative:
        errs.append(f"{p.name}: needs both positive and negative fixtures")
    for kind, snippets, want in (("positive", p.positive, True),
                                 ("negative", p.negative, False)):
        for i, src in enumerate(snippets):
            rel = p.fixture_rel or f"fixture_{p.name}_{kind}_{i}.py"
            mod = SourceModule.from_source(src, rel=rel)
            got = [f for f in p.run([mod], ctx)
                   if mod.suppression_for(f.rule, f.line) is None]
            if want and not got:
                errs.append(f"{p.name}: {kind} fixture #{i} "
                            "produced no finding")
            if not want and got:
                errs.append(f"{p.name}: {kind} fixture #{i} produced: "
                            + "; ".join(f.format() for f in got))
    return errs


# ---------------------------------------------------------------------------
# triage: suppressions then baseline
# ---------------------------------------------------------------------------


def apply_suppressions(findings: List[Finding],
                       modules_by_rel: Dict[str, SourceModule],
                       passes_by_rule: Dict[str, Pass]):
    """Split findings into (active, suppressed).  A reason-less
    suppression on a ``requires_reason`` rule stays active."""
    active, suppressed = [], []
    for f in findings:
        mod = modules_by_rel.get(f.path)
        s = mod.suppression_for(f.rule, f.line) if mod else None
        if s is None:
            active.append(f)
            continue
        p = passes_by_rule.get(f.rule)
        if p is not None and p.requires_reason and not s.reason:
            active.append(Finding(
                f.rule, f.path, f.line,
                f.message + f"  (suppression found but `{f.rule}` "
                "requires a reason: append ' -- <why>')", f.severity))
        else:
            suppressed.append(f)
    return active, suppressed


def load_baseline(path: str):
    """-> (entries, errors).  Malformed files error rather than hide."""
    if not os.path.exists(path):
        return [], []
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError) as e:
        return [], [f"cannot read baseline {path}: {e}"]
    entries = data.get("entries", [])
    if not isinstance(entries, list):
        return [], [f"baseline {path}: 'entries' must be a list"]
    return entries, []


def apply_baseline(findings: List[Finding], entries: List[dict],
                   modules_by_rel: Dict[str, SourceModule],
                   check_stale: bool = True):
    """Split findings into (active, baselined, errors).

    Matching is by (rule, path, stripped-source-line anchor).  Every
    entry needs a reason; with ``check_stale`` an entry matching no
    live finding errors — the baseline may only shrink."""
    errors: List[str] = []
    used = [0] * len(entries)
    active, baselined = [], []
    for f in findings:
        mod = modules_by_rel.get(f.path)
        anchor = mod.line(f.line).strip() if mod else ""
        hit = None
        for i, e in enumerate(entries):
            if (e.get("rule") == f.rule and e.get("path") == f.path
                    and str(e.get("anchor", "")).strip() == anchor):
                hit = i
                break
        if hit is None:
            active.append(f)
        else:
            used[hit] += 1
            baselined.append(f)
    for i, e in enumerate(entries):
        where = f"{e.get('rule')} @ {e.get('path')}"
        if not str(e.get("reason", "")).strip():
            errors.append(f"baseline entry {i} ({where}) has no reason — "
                          "every deliberate deferral needs one")
        if check_stale and not used[i]:
            errors.append(
                f"stale baseline entry {i} ({where}): matches no current "
                "finding — delete it; the baseline may only shrink")
    return active, baselined, errors


# ---------------------------------------------------------------------------
# small shared helpers
# ---------------------------------------------------------------------------


def flags_aliases(tree: ast.AST) -> set:
    """Names the module binds to the flag registry (GLOBAL_FLAGS plus
    any ``from …flags import GLOBAL_FLAGS as X`` alias)."""
    out = {"GLOBAL_FLAGS"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "GLOBAL_FLAGS":
                    out.add(a.asname or a.name)
    return out
