#!/usr/bin/env python3
"""ptlint over the port — the command-line entry of
``paddle_tpu_torch/analysis/`` (JAX: ``tools/ptlint.py``).

Runs the port's pass registry (capture-purity, lock-discipline,
clock-hygiene, silent-failure, flag-freeze, flags-doc, metrics-doc,
metric-hygiene) over ``paddle_tpu_torch/`` and ``chip_smoke.py``.  Pure
stdlib, no torch: the analysis package is loaded standalone by path, so
a lint run never executes ``paddle_tpu_torch/__init__.py`` and takes
milliseconds.  It runs from any working directory.

Usage:
  python paddle_tpu_torch/analysis/ptlint.py --all
        lint paddle_tpu_torch/ and chip_smoke.py (CI mode)
  python paddle_tpu_torch/analysis/ptlint.py --all --self-test
        also run every pass's fixtures
  python paddle_tpu_torch/analysis/ptlint.py path/to/file.py …
        lint specific files/dirs
  python paddle_tpu_torch/analysis/ptlint.py --list
        print the rule catalog
  python paddle_tpu_torch/analysis/ptlint.py --all --json
        machine-readable findings

Exit 0 iff zero unsuppressed findings and the baseline is healthy
(every entry has a reason and still matches — the baseline may only
shrink).  Suppression syntax and policy are the JAX linter's:
docs/static_analysis.md.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(PKG))
BASELINE = os.path.join(PKG, "ptlint_baseline.json")
DEFAULT_SCAN = ("paddle_tpu_torch", "chip_smoke.py")
#: the name the standalone package is registered under
MODULE_NAME = "ptt_analysis"


def load_analysis():
    """Import paddle_tpu_torch/analysis as a standalone package.

    Going through ``import paddle_tpu_torch.analysis`` would execute
    ``paddle_tpu_torch/__init__.py`` and pull in torch; loading the
    package by path keeps the no-framework-import contract."""
    if MODULE_NAME in sys.modules:
        return sys.modules[MODULE_NAME]
    spec = importlib.util.spec_from_file_location(
        MODULE_NAME, os.path.join(PKG, "__init__.py"),
        submodule_search_locations=[PKG])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[MODULE_NAME] = mod
    spec.loader.exec_module(mod)
    return mod


ANALYSIS = load_analysis()


def run_lint(paths=None, json_out=False, baseline_path=BASELINE,
             root=ROOT, out=sys.stdout, err=sys.stderr) -> int:
    base = ANALYSIS.base
    explicit = bool(paths)
    if explicit:
        subdirs = [os.path.relpath(os.path.abspath(p), root)
                   for p in paths]
    else:
        subdirs = DEFAULT_SCAN
    parse_errors = []
    modules = base.load_modules(
        root, subdirs,
        on_error=lambda p, e: parse_errors.append(f"{p}: {e}"))
    ctx = base.Context(root=root)
    passes = ANALYSIS.all_passes()
    findings = []
    for p in passes:
        findings.extend(p.run(modules, ctx))
    by_rel = {m.rel: m for m in modules}
    active, suppressed = base.apply_suppressions(
        findings, by_rel, {p.name: p for p in passes})
    entries, errors = base.load_baseline(baseline_path)
    # with an explicit path subset, entries for unscanned files are not
    # stale — skip the shrink check
    active, baselined, berrors = base.apply_baseline(
        active, entries, by_rel, check_stale=not explicit)
    errors = parse_errors + errors + berrors
    active.sort(key=lambda f: (f.path, f.line, f.rule))
    if json_out:
        print(json.dumps({
            "findings": [vars(f) for f in active],
            "suppressed": len(suppressed),
            "baselined": len(baselined),
            "errors": errors,
        }, indent=2), file=out)
    else:
        for f in active:
            print(f.format(), file=err)
        for e in errors:
            print(f"ptlint: {e}", file=err)
        if active or errors:
            print(f"ptlint: {len(active)} finding(s), "
                  f"{len(errors)} error(s) over {len(modules)} files",
                  file=err)
        else:
            print(f"ptlint: OK ({len(passes)} passes, {len(modules)} "
                  f"files, {len(suppressed)} suppressed, "
                  f"{len(baselined)} baselined)", file=out)
    return 1 if (active or errors) else 0


def run_self_test(out=sys.stdout, err=sys.stderr) -> int:
    passes = ANALYSIS.all_passes()
    errs = []
    for p in passes:
        errs.extend(p.self_test())
    for e in errs:
        print(f"ptlint self-test: {e}", file=err)
    if errs:
        print(f"ptlint self-test: {len(errs)} failure(s)", file=err)
        return 1
    print(f"ptlint self-test: OK ({len(passes)} passes)", file=out)
    return 0


def run_list(out=sys.stdout) -> int:
    for p in ANALYSIS.all_passes():
        extra = " [suppression requires a reason]" \
            if p.requires_reason else ""
        print(f"{p.name:16s} {p.help}{extra}", file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ptlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--all", action="store_true",
                    help="lint the default tree (paddle_tpu_torch/, "
                         "chip_smoke.py)")
    ap.add_argument("--self-test", action="store_true",
                    help="run every pass's positive/negative fixtures")
    ap.add_argument("--list", action="store_true",
                    help="print the rule catalog")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON")
    ap.add_argument("--baseline", default=BASELINE,
                    help="baseline file (default "
                         "paddle_tpu_torch/analysis/ptlint_baseline.json)")
    ap.add_argument("paths", nargs="*",
                    help="specific files/directories to lint")
    args = ap.parse_args(argv)

    if args.list:
        return run_list()
    rc = 0
    ran = False
    if args.self_test:
        ran = True
        rc = max(rc, run_self_test())
    if args.all or args.paths:
        ran = True
        rc = max(rc, run_lint(paths=args.paths or None,
                              json_out=args.json,
                              baseline_path=args.baseline))
    if not ran:
        ap.print_usage(sys.stderr)
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
