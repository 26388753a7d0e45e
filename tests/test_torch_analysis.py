"""The port's ptlint (``paddle_tpu_torch/analysis/``) held against the JAX
package's (``paddle_tpu/analysis/`` through ``tools/ptlint.py``).

- every port pass's fixtures, and the registry's fixed order;
- the seven shared passes give the JAX passes' findings on the union of
  both packages' fixtures, and the same per-rule counts over either tree;
- capture purity: its fixtures, trace purity's positives rewritten as
  captures, and the real captured bodies of the port reached and
  guarded;
- the standalone load (no torch, no framework ``__init__``), the tier-1
  gate, the shrink-only baseline and the seeded-violation CLI run.

Both analysis packages are loaded by path, as their command-line entries
load them, so nothing here imports torch or jax for the lint itself.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import collections
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
PORT_PKG = os.path.join(ROOT, "paddle_tpu_torch", "analysis")
PORT_CLI = os.path.join(PORT_PKG, "ptlint.py")
PORT_BASELINE = os.path.join(PORT_PKG, "ptlint_baseline.json")
JAX_BASELINE = os.path.join(TOOLS, "ptlint_baseline.json")

sys.path.insert(0, TOOLS)
import ptlint as jax_ptlint  # noqa: E402


def _load_port_cli():
    name = "ptt_ptlint_cli"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, PORT_CLI)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


port_ptlint = _load_port_cli()
PORT = port_ptlint.ANALYSIS
JAX = jax_ptlint.ANALYSIS

PORT_PASSES = PORT.all_passes()
PORT_IDS = [p.name for p in PORT_PASSES]
SHARED = ["lock-discipline", "clock-hygiene", "silent-failure",
          "flag-freeze", "flags-doc", "metrics-doc", "metric-hygiene"]


def _pass(analysis, name):
    return [p for p in analysis.all_passes() if p.name == name][0]


# ---------------------------------------------------------------------------
# the registry and every pass's fixtures
# ---------------------------------------------------------------------------

def test_registry_order():
    assert PORT_IDS == ["capture-purity"] + SHARED


@pytest.mark.parametrize("p", PORT_PASSES, ids=PORT_IDS)
def test_pass_has_enough_fixtures(p):
    assert len(p.positive) >= 2, f"{p.name}: needs >=2 positive fixtures"
    assert len(p.negative) >= 2, f"{p.name}: needs >=2 negative fixtures"


@pytest.mark.parametrize("p", PORT_PASSES, ids=PORT_IDS)
def test_pass_fixtures_behave(p):
    errs = p.self_test()
    assert errs == [], "\n".join(errs)


# ---------------------------------------------------------------------------
# shared-pass parity with the JAX package
# ---------------------------------------------------------------------------

_PKG = {"jax": "paddle_tpu", "port": "paddle_tpu_torch"}
_DOCS = "FLAGS_alpha — the documented one"
_METRICS_DOC = "serving.documented_total — row"


def _fixture_rel(rule, pkg, i):
    """The fixture's path inside the package each linter checks (the doc
    passes look at flags.py and at their own package only)."""
    if rule == "flags-doc":
        return f"{pkg}/flags.py"
    return f"{pkg}/fixture_{i}.py"


def _normalised(findings, suppressed, pkg):
    """(rule, path, line, message, suppressed) with the package's name,
    where a path or message names it, read as <pkg>."""
    rx = re.compile(rf"\b{pkg}\b")
    return sorted((f.rule, rx.sub("<pkg>", f.path), f.line,
                   rx.sub("<pkg>", f.message), f in suppressed)
                  for f in findings)


def _lint_fixture(analysis, side, rule, src, i):
    base = analysis.base
    p = _pass(analysis, rule)
    pkg = _PKG[side]
    mod = base.SourceModule.from_source(src, rel=_fixture_rel(rule, pkg, i))
    ctx = base.Context(root=None, docs_text=_DOCS,
                       metrics_doc_text=_METRICS_DOC)
    found = p.run([mod], ctx)
    _, suppressed = base.apply_suppressions(found, {mod.rel: mod},
                                            {p.name: p})
    return _normalised(found, suppressed, pkg)


@pytest.mark.parametrize("rule", SHARED)
def test_shared_pass_findings_match_jax_on_both_fixture_sets(rule):
    """Every fixture of either package, linted by each package's pass,
    gives the same findings (rule, path, line, message, suppressed)."""
    jp, pp = _pass(JAX, rule), _pass(PORT, rule)
    snippets = [*jp.positive, *jp.negative, *pp.positive, *pp.negative]
    fired = 0
    for i, src in enumerate(snippets):
        got_jax = _lint_fixture(JAX, "jax", rule, src, i)
        got_port = _lint_fixture(PORT, "port", rule, src, i)
        assert got_port == got_jax, f"fixture #{i}:\n{src}"
        fired += len(got_port)
    assert fired >= len(jp.positive) + len(pp.positive)


def _triage(analysis, passes, subdirs, baseline):
    """Per-rule Counter of active / suppressed / baselined findings of
    ``passes`` over ``subdirs``, and the baseline's errors."""
    base = analysis.base
    mods = base.load_modules(ROOT, subdirs)
    ctx = base.Context(root=ROOT)
    found = [f for p in passes for f in p.run(mods, ctx)]
    by_rel = {m.rel: m for m in mods}
    active, suppressed = base.apply_suppressions(
        found, by_rel, {p.name: p for p in passes})
    entries, errors = base.load_baseline(baseline)
    active, baselined, berrors = base.apply_baseline(
        active, entries, by_rel, check_stale=False)
    counts = collections.Counter()
    for kind, fs in (("active", active), ("suppressed", suppressed),
                     ("baselined", baselined)):
        for f in fs:
            counts[(f.rule, kind)] += 1
    return counts, errors + berrors


def _shared(analysis):
    return [p for p in analysis.all_passes() if p.name in SHARED]


@pytest.mark.parametrize("tree,baseline", [
    (("paddle_tpu",), JAX_BASELINE),
    (("paddle_tpu_torch", "chip_smoke.py"), PORT_BASELINE),
], ids=["jax-tree", "port-tree"])
def test_shared_passes_count_alike_on_each_tree(tree, baseline):
    """The port's seven shared passes and the JAX ones give the same
    per-rule active, suppressed and baselined counts over the JAX tree
    (with the JAX baseline) and over the port (with the port's)."""
    port, perr = _triage(PORT, _shared(PORT), tree, baseline)
    jax, jerr = _triage(JAX, _shared(JAX), tree, baseline)
    assert perr == jerr == []
    assert port == jax
    assert not [k for k in port if k[1] == "active"], port
    assert port[("silent-failure", "suppressed")] > 0


def test_jax_linter_passes_the_port_with_its_baseline():
    """The JAX ptlint over paddle_tpu_torch/ and chip_smoke.py, given the
    port's baseline, exits 0: the two linters agree on the port."""
    out, err = io.StringIO(), io.StringIO()
    rc = jax_ptlint.run_lint(
        paths=[os.path.join(ROOT, "paddle_tpu_torch"),
               os.path.join(ROOT, "chip_smoke.py")],
        baseline_path=PORT_BASELINE, out=out, err=err)
    assert rc == 0, err.getvalue()
    assert "1 baselined" in out.getvalue()


def test_suppression_syntax_is_the_jax_one():
    """One annotation means the same to both linters: the same pattern,
    and the same suppressions parsed from every file of the port."""
    assert PORT.base._SUPPRESS_RE.pattern == JAX.base._SUPPRESS_RE.pattern
    n = 0
    for m in PORT.base.load_modules(ROOT, port_ptlint.DEFAULT_SCAN):
        theirs = JAX.base.parse_suppressions(JAX.base.comment_lines(m.text))
        assert [vars(s) for s in m.suppressions] \
            == [vars(s) for s in theirs], m.rel
        n += len(m.suppressions)
    assert n > 0


# ---------------------------------------------------------------------------
# capture purity
# ---------------------------------------------------------------------------

CAPTURE = _pass(PORT, "capture-purity")


def _capture_findings(src, rel="paddle_tpu_torch/fixture_mod.py"):
    mod = PORT.base.SourceModule.from_source(src, rel=rel)
    found = CAPTURE.run([mod], PORT.base.Context(root=None))
    return [f for f in found
            if mod.suppression_for(f.rule, f.line) is None]


@pytest.mark.parametrize("i", range(len(CAPTURE.positive)))
def test_capture_purity_positive_fixture_fires(i):
    assert _capture_findings(CAPTURE.positive[i])


@pytest.mark.parametrize("i", range(len(CAPTURE.negative)))
def test_capture_purity_negative_fixture_is_quiet(i):
    assert _capture_findings(CAPTURE.negative[i]) == []


_JIT_RE = re.compile(r"jax\.jit\((.+?)\)")


@pytest.mark.parametrize("form", [r"_capture(self, graph, \1)",
                                  r"self._backend.capture(\1)"],
                         ids=["static-capture", "backend-capture"])
@pytest.mark.parametrize("i", range(len(_pass(JAX, "trace-purity")
                                        .positive)))
def test_trace_purity_positives_fire_as_captures(i, form):
    src = _pass(JAX, "trace-purity").positive[i]
    assert _JIT_RE.search(src)
    rewritten = _JIT_RE.sub(form, src)
    assert "jax.jit" not in rewritten
    assert _capture_findings(rewritten)


def _port_graph(rel):
    mod = [m for m in PORT.base.load_modules(ROOT, (rel,))][0]
    graph = PORT.capturegraph.ModuleGraph(mod)
    reached = {(graph.enclosing_class_name(fn),
                PORT.capturegraph.root_name(fn))
               for fn, _ in graph.reachable(graph.capture_roots()).values()}
    return mod, reached


@pytest.mark.parametrize("rel,owner,fn", [
    ("paddle_tpu_torch/static/__init__.py", "TrainStep", "_step"),
    ("paddle_tpu_torch/static/__init__.py", "EvalStep", "_step"),
    ("paddle_tpu_torch/static/__init__.py", None, "apply_fault_mults"),
    ("paddle_tpu_torch/inference/__init__.py", "_Shared", "call"),
])
def test_capture_graph_reaches_the_port_bodies(rel, owner, fn):
    _, reached = _port_graph(rel)
    assert (owner, fn) in reached, sorted(reached, key=str)


@pytest.mark.parametrize("rel,anchor,inject", [
    # the form the skip guard's count had: a host rebinding of the attr
    ("paddle_tpu_torch/static/__init__.py",
     "self.nonfinite_steps.add_(found_inf.to(torch.int64))",
     "self.nonfinite_steps += found_inf.to(torch.int64)"),
    ("paddle_tpu_torch/static/__init__.py",
     "was_training = self.model.training",
     "was_training = self.model.training or time.time() < 0"),
    ("paddle_tpu_torch/inference/__init__.py",
     "return self.module(self.params, self.buffers, *args)",
     "return self.module(self.params, self.buffers, *args).cpu()"),
], ids=["train-step-self-write", "eval-step-clock", "predictor-host-sync"])
def test_seeded_effect_in_a_captured_body_fires(rel, anchor, inject):
    """The real bodies are guarded: the port's file is clean, and the
    same file with one effect seeded into a captured body is not."""
    with open(os.path.join(ROOT, rel)) as fh:
        text = fh.read()
    assert _capture_findings(text, rel) == []
    assert text.count(anchor) == 1, anchor
    seeded = text.replace(anchor, inject)
    line = text[:text.index(anchor)].count("\n") + 1
    found = _capture_findings(seeded, rel)
    assert [f.line for f in found] == [line], found


# ---------------------------------------------------------------------------
# standalone load, the gate, the baseline, explicit paths
# ---------------------------------------------------------------------------

def test_analysis_imports_only_the_standard_library():
    import ast
    for name in sorted(os.listdir(PORT_PKG)):
        if not name.endswith(".py"):
            continue
        path = os.path.join(PORT_PKG, name)
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            for top in tops:
                assert top in sys.stdlib_module_names, (name, top)


def test_analysis_loads_standalone_without_torch():
    code = (
        "import importlib.util, os, sys\n"
        "had_jax = 'jax' in sys.modules\n"
        f"pkg = {PORT_PKG!r}\n"
        "spec = importlib.util.spec_from_file_location(\n"
        "    'ptt_analysis', os.path.join(pkg, '__init__.py'),\n"
        "    submodule_search_locations=[pkg])\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules['ptt_analysis'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "assert len(mod.all_passes()) == 8\n"
        "for banned in ('torch', 'paddle_tpu_torch', 'paddle_tpu'):\n"
        "    assert banned not in sys.modules, banned\n"
        "assert had_jax or 'jax' not in sys.modules, 'imported jax'\n"
        "print('standalone-ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "standalone-ok" in proc.stdout


def test_gate_all_self_test_from_another_cwd(tmp_path):
    proc = subprocess.run(
        [sys.executable, PORT_CLI, "--all", "--self-test"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "ptlint self-test: OK (8 passes)" in proc.stdout
    assert "ptlint: OK (8 passes" in proc.stdout


def test_gate_json_from_another_cwd(tmp_path):
    proc = subprocess.run(
        [sys.executable, PORT_CLI, "--all", "--json"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    data = json.loads(proc.stdout)
    assert data["findings"] == []
    assert data["errors"] == []
    assert data["suppressed"] > 0
    assert data["baselined"] <= 1


def test_checked_in_baseline_is_small_and_reasoned():
    """At most one entry (the engine's wall-clock watchdog stamps), in
    the JAX baseline's format: shrink it, never grow it."""
    with open(PORT_BASELINE) as fh:
        entries = json.load(fh)["entries"]
    with open(JAX_BASELINE) as fh:
        jax_keys = {tuple(sorted(e)) for e in json.load(fh)["entries"]}
    assert len(entries) <= 1
    for e in entries:
        assert tuple(sorted(e)) in jax_keys, e
        assert str(e.get("reason", "")).strip(), e
        assert e["path"].startswith("paddle_tpu_torch/"), e


def _clock_module(base, rel="paddle_tpu_torch/m.py"):
    src = """
    import time

    def f():
        t0 = time.time()
        return time.time() - t0
    """
    return base.SourceModule.from_source(src, rel=rel)


def test_baseline_stale_entry_errors():
    base = PORT.base
    entries = [{"rule": "clock-hygiene", "path": "paddle_tpu_torch/gone.py",
                "anchor": "x = 1", "reason": "old"}]
    _, _, errors = base.apply_baseline([], entries, {}, check_stale=True)
    assert any("stale" in e for e in errors)
    _, _, errors = base.apply_baseline([], entries, {}, check_stale=False)
    assert errors == []


def test_baseline_entry_without_reason_errors():
    base = PORT.base
    mod = _clock_module(base)
    findings = _pass(PORT, "clock-hygiene").run([mod], base.Context())
    assert findings
    entries = [{"rule": "clock-hygiene", "path": mod.rel,
                "anchor": mod.line(findings[0].line).strip()}]
    active, baselined, errors = base.apply_baseline(
        findings, entries, {mod.rel: mod})
    assert baselined and not active
    assert any("no reason" in e for e in errors)


def test_baseline_matches_by_anchor_not_line():
    base = PORT.base
    p = _pass(PORT, "clock-hygiene")
    mod = _clock_module(base)
    findings = p.run([mod], base.Context())
    entries = [{"rule": "clock-hygiene", "path": mod.rel,
                "anchor": mod.line(findings[0].line).strip(),
                "reason": "pinned"}]
    drifted = "# new header comment\n# another line\n" + mod.text
    mod2 = base.SourceModule("<fixture>", mod.rel, drifted)
    findings2 = p.run([mod2], base.Context())
    assert findings2[0].line == findings[0].line + 2
    active, baselined, errors = base.apply_baseline(
        findings2, entries, {mod2.rel: mod2})
    assert not active and baselined and not errors


@pytest.mark.parametrize("rule,src", [
    ("clock-hygiene",
     "import time\n\ndef f():\n    t0 = time.time()\n"
     "    return time.time() - t0\n"),
    ("capture-purity",
     "import time\nimport torch\n\ndef f(g, x):\n"
     "    with torch.cuda.graph(g):\n        y = x * time.time()\n"
     "    return y\n"),
    ("silent-failure",
     "def f(s):\n    try:\n        s.close()\n"
     "    except OSError:  # ptlint: disable=silent-failure\n"
     "        pass\n"),
])
def test_seeded_violation_by_path_exits_1(tmp_path, rule, src):
    """A seeded file linted by explicit path: the finding, exit 1, and
    the baseline's entries for unscanned files are not stale."""
    bad = tmp_path / "bad.py"
    bad.write_text(src)
    proc = subprocess.run([sys.executable, PORT_CLI, str(bad)],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode == 1, proc.stderr + proc.stdout
    assert f"[{rule}]" in proc.stderr
    assert "stale" not in proc.stderr


@pytest.mark.parametrize("module", ["flags_doc", "metrics_doc"])
def test_doc_checkers_point_at_the_port(module, capsys):
    mod = getattr(PORT, module)
    target = mod.FLAGS_PY if module == "flags_doc" else mod.PKG_DIR
    assert os.path.relpath(target, ROOT).split(os.sep)[0] \
        == "paddle_tpu_torch"
    assert mod.cli_main() == 0
    assert ": OK (" in capsys.readouterr().out
