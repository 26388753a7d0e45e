"""metrics-doc: every metric name the port registers must be documented
(JAX: ``paddle_tpu/analysis/metrics_doc.py``).

Every literal-named ``counter(...)`` / ``gauge(...)`` /
``histogram(...)`` / ``stat_add(...)`` in ``paddle_tpu_torch/`` and
every literal ``pt_mon_add("...")`` in ``csrc/*.cc`` (the sources the
port's native library builds from) must appear in
``docs/observability.md`` — the canonical index scrapers and dashboards
are built from, shared with the JAX package and read, never written.
Dynamically-named instruments and ``selftest_*`` fixtures are out of
scope.  ``cli_main`` keeps the JAX module's CLI output, pointed at the
port.
"""

from __future__ import annotations

import ast
import os
import re
import sys

from . import base
from .base import Context, Finding, Pass, fixture_self_test

ROOT = base.ROOT
PKG_DIR = os.path.join(ROOT, "paddle_tpu_torch")
CSRC_DIR = os.path.join(ROOT, "csrc")
DOC = os.path.join(ROOT, "docs", "observability.md")

_FACTORIES = {"counter", "gauge", "histogram"}
# native stat registrations: C++ pt_mon_add / Python native.stat_add
_NATIVE_FACTORIES = {"stat_add"}
_PT_MON_RE = re.compile(r'pt_mon_add\(\s*"([^"]+)"')


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _tree_metrics(tree):
    """[(name, lineno)] literal-named instruments in one parsed file."""
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and (_call_name(node) in _FACTORIES
                     or _call_name(node) in _NATIVE_FACTORIES)
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        name = node.args[0].value
        if not name or name.startswith("selftest_"):
            continue
        out.append((name, node.lineno))
    return out


def collect_metrics(pkg_dir: str = PKG_DIR):
    """{name: [file:line, ...]} for every literal-named instrument."""
    out = {}
    for dirpath, _, files in os.walk(pkg_dir):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path) as fh:
                    tree = ast.parse(fh.read(), filename=path)
            except SyntaxError as e:  # pragma: no cover
                print(f"check_metrics_doc: cannot parse {path}: {e}",
                      file=sys.stderr)
                return None
            rel = os.path.relpath(path, ROOT)
            for name, lineno in _tree_metrics(tree):
                out.setdefault(name, []).append(f"{rel}:{lineno}")
    return out


def collect_native_metrics(csrc_dir: str = CSRC_DIR):
    """{name: [file:line, ...]} for every literal pt_mon_add() stat in
    the C++ sources (regex scan — no C++ parser needed for literal
    first arguments; dynamically-built names are out of scope like
    their Python counterparts)."""
    out = {}
    if not os.path.isdir(csrc_dir):
        return out
    for fname in sorted(os.listdir(csrc_dir)):
        if not fname.endswith((".cc", ".c", ".h")):
            continue
        path = os.path.join(csrc_dir, fname)
        try:
            with open(path) as fh:
                text = fh.read()
        except OSError:  # pragma: no cover
            continue
        for i, line in enumerate(text.splitlines(), 1):
            for m in _PT_MON_RE.finditer(line):
                rel = os.path.relpath(path, ROOT)
                out.setdefault(m.group(1), []).append(f"{rel}:{i}")
    return out


class MetricsDocPass(Pass):
    name = "metrics-doc"
    help = ("every literal metric name (Python factories + native "
            "pt_mon_add/stat_add) must appear in docs/observability.md")
    fixture_rel = "paddle_tpu_torch/fixture_mod.py"

    def run(self, modules, ctx):
        doc = ctx.metrics_doc_text
        if doc is None:
            if not ctx.root:
                doc = ""
            else:
                try:
                    with open(DOC) as fh:
                        doc = fh.read()
                except OSError:
                    doc = ""
        out = []
        reported = set()
        for mod in modules:
            if not mod.rel.startswith("paddle_tpu_torch/"):
                continue
            for name, lineno in _tree_metrics(mod.tree):
                if name in doc or name in reported:
                    continue
                reported.add(name)
                out.append(Finding(
                    self.name, mod.rel, lineno,
                    f"metric `{name}` is registered here but not "
                    "mentioned in docs/observability.md — add its row "
                    "to the canonical index"))
        if ctx.root:
            for name, sites in collect_native_metrics().items():
                if name in doc or name in reported:
                    continue
                # native findings anchor on the doc file (csrc isn't a
                # parsed module); the message carries the real site
                out.append(Finding(
                    self.name, "docs/observability.md", 1,
                    f"native stat `{name}` (registered at "
                    f"{', '.join(sites)}) is not mentioned in "
                    "docs/observability.md"))
        return out

    def self_test(self):
        ctx = Context(root=None,
                      metrics_doc_text="serving.documented_total — row")
        return fixture_self_test(self, ctx)

    positive = (
        'c = counter("m_undoc_total", "h")\n',
        'h = obs.histogram("lat_undoc_ms", "h")\n',
    )
    negative = (
        'c = counter("serving.documented_total", "h")\n',  # documented
        'c = counter("selftest_x", "h")\nd = counter(dyn_name, "h")\n',
    )


def cli_main() -> int:
    """The JAX module's ``check_metrics_doc`` CLI, over the port."""
    metrics = collect_metrics()
    if metrics is None:
        return 1
    if not metrics:
        print("check_metrics_doc: no instrument registrations found "
              f"under {PKG_DIR} — parser broken?", file=sys.stderr)
        return 1
    for name, sites in collect_native_metrics().items():
        metrics.setdefault(name, []).extend(sites)
    try:
        with open(DOC) as fh:
            doc = fh.read()
    except OSError as e:
        print(f"check_metrics_doc: cannot read {DOC}: {e}",
              file=sys.stderr)
        return 1
    missing = {n: sites for n, sites in metrics.items() if n not in doc}
    for name in sorted(missing):
        print(f"{name}: registered at {', '.join(missing[name])} but "
              "not mentioned in docs/observability.md",
              file=sys.stderr)
    if missing:
        print(f"check_metrics_doc: {len(missing)} undocumented of "
              f"{len(metrics)} metric names", file=sys.stderr)
        return 1
    print(f"check_metrics_doc: OK ({len(metrics)} metric names "
          "documented)")
    return 0
