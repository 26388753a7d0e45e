"""flags-doc: every flag of the port has help text and a docs mention
(JAX: ``paddle_tpu/analysis/flags_doc.py``).

Walks the ``define_flag`` calls in ``paddle_tpu_torch/flags.py`` by AST
and fails when a flag's ``help`` is empty/missing or the flag is not
mentioned (as ``FLAGS_<name>``) anywhere under ``docs/``, which it reads
and never writes.  ``docs/flags.md`` is the canonical index, shared
with the JAX package.  ``cli_main`` keeps the JAX module's CLI output,
pointed at the port's flags.
"""

from __future__ import annotations

import ast
import os
import sys

from . import base
from .base import Context, Finding, Pass, fixture_self_test

ROOT = base.ROOT
FLAGS_PY = os.path.join(ROOT, "paddle_tpu_torch", "flags.py")
DOCS_DIR = os.path.join(ROOT, "docs")


def collect_flags_detail(path: str = FLAGS_PY, tree=None):
    """[(name, has_help, lineno)] for every define_flag(...) call."""
    if tree is None:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "define_flag"):
            continue
        if not node.args or not isinstance(node.args[0], ast.Constant):
            continue
        name = node.args[0].value
        help_node = None
        if len(node.args) >= 3:
            help_node = node.args[2]
        for kw in node.keywords:
            if kw.arg == "help":
                help_node = kw.value
        has_help = (isinstance(help_node, ast.Constant)
                    and isinstance(help_node.value, str)
                    and bool(help_node.value.strip()))
        out.append((name, has_help, node.lineno))
    return out


def collect_flags(path: str = FLAGS_PY):
    """[(name, has_help)] for every define_flag(...) call."""
    return [(n, h) for n, h, _ in collect_flags_detail(path)]


def docs_text(docs_dir: str = DOCS_DIR) -> str:
    chunks = []
    for dirpath, _, files in os.walk(docs_dir):
        for f in files:
            if f.endswith((".md", ".rst", ".txt")):
                with open(os.path.join(dirpath, f)) as fh:
                    chunks.append(fh.read())
    return "\n".join(chunks)


class FlagsDocPass(Pass):
    name = "flags-doc"
    help = ("every define_flag(...) needs non-empty help= and a "
            "FLAGS_<name> mention under docs/")
    fixture_rel = "paddle_tpu_torch/flags.py"

    def run(self, modules, ctx):
        docs = ctx.docs_text
        if docs is None:
            docs = docs_text() if ctx.root else ""
        out = []
        for mod in modules:
            if not mod.rel.endswith("flags.py"):
                continue
            for name, has_help, lineno in collect_flags_detail(
                    tree=mod.tree):
                if not has_help:
                    out.append(Finding(
                        self.name, mod.rel, lineno,
                        f"FLAGS_{name}: empty or missing help= — every "
                        "flag carries a descriptive string"))
                if f"FLAGS_{name}" not in docs:
                    out.append(Finding(
                        self.name, mod.rel, lineno,
                        f"FLAGS_{name}: not documented anywhere under "
                        "docs/ (add it to docs/flags.md)"))
        return out

    def self_test(self):
        ctx = Context(root=None,
                      docs_text="FLAGS_alpha — the documented one")
        return fixture_self_test(self, ctx)

    positive = (
        'define_flag("beta", 1, "")\n',            # empty help
        'define_flag("gamma", 1, "has help")\n',   # undocumented
    )
    negative = (
        'define_flag("alpha", 1, "help text")\n',  # documented + helped
        'x = 1\n',                                 # no flags at all
    )


def cli_main() -> int:
    """The JAX module's ``check_flags_doc`` CLI, over the port's flags."""
    flags = collect_flags()
    if not flags:
        print("check_flags_doc: no define_flag calls found "
              f"in {FLAGS_PY} — parser broken?", file=sys.stderr)
        return 1
    docs = docs_text()
    bad_help = [n for n, has_help in flags if not has_help]
    undocumented = [n for n, _ in flags if f"FLAGS_{n}" not in docs]
    for n in bad_help:
        print(f"FLAGS_{n}: empty or missing help= in flags.py",
              file=sys.stderr)
    for n in undocumented:
        print(f"FLAGS_{n}: not documented anywhere under docs/ "
              "(add it to docs/flags.md)", file=sys.stderr)
    if bad_help or undocumented:
        print(f"check_flags_doc: {len(bad_help)} empty-help, "
              f"{len(undocumented)} undocumented "
              f"(of {len(flags)} flags)", file=sys.stderr)
        return 1
    print(f"check_flags_doc: OK ({len(flags)} flags documented)")
    return 0
