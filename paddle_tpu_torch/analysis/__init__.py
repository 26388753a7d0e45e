"""paddle_tpu_torch.analysis — the ptlint passes over the port (JAX:
``paddle_tpu/analysis/__init__.py``).

Small composable AST passes over ``paddle_tpu_torch/`` and
``chip_smoke.py``, driven by ``ptlint.py`` in this directory and the
tier-1 test suite.

**Import contract:** everything in this package is stdlib-only (ast /
json / os / re / tokenize / argparse).  ``ptlint.py`` loads it
standalone by path *without* going through
``paddle_tpu_torch/__init__.py`` (which imports torch), so a lint run
takes milliseconds and imports no framework.  Never import from the
parent package here, and nothing of the JAX package: this package keeps
its own copy of everything it needs.

Rule catalog (docs/static_analysis.md has the long form of the shared
rules):

- ``capture-purity``   host effects and host syncs in code reachable
                       from a CUDA-graph capture (trace-purity's
                       counterpart)
- ``lock-discipline``  `# guarded-by:` fields mutate only under their lock
- ``clock-hygiene``    wall-clock time.time() in duration subtractions
- ``silent-failure``   `except …: pass` without a counter or a reason
- ``flag-freeze``      GLOBAL_FLAGS.get(...) at module import time
- ``flags-doc``        the port's flags need help= + docs
- ``metrics-doc``      the port's metric names need docs
- ``metric-hygiene``   instrument kind must match the name contract

The JAX ``callback-cache`` rule has no counterpart: it guards the
persistent compile cache against host callbacks in traced code, and a
CUDA graph has neither a host callback nor a persistent cache.
"""

from . import base, capturegraph  # noqa: F401  (re-exported submodules)
from . import (capture_purity, clock_hygiene, flag_freeze, flags_doc,
               lock_discipline, metric_hygiene, metrics_doc,
               silent_failure)
from .base import Context, Finding, Pass, SourceModule  # noqa: F401

_PASSES = None


def all_passes():
    """One fresh registry instance list (stable order = report order)."""
    global _PASSES
    if _PASSES is None:
        _PASSES = [
            capture_purity.CapturePurityPass(),
            lock_discipline.LockDisciplinePass(),
            clock_hygiene.ClockHygienePass(),
            silent_failure.SilentFailurePass(),
            flag_freeze.FlagFreezePass(),
            flags_doc.FlagsDocPass(),
            metrics_doc.MetricsDocPass(),
            metric_hygiene.MetricHygienePass(),
        ]
    return list(_PASSES)
