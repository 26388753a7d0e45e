"""Deterministic fault injection for chaos drills.

Production fault-tolerance code is only trustworthy if the failure path
runs — this module makes failures reproducible. ``FLAGS_fault_spec``
arms a registry of fault entries; the framework's injection points
(checkpoint writer, data-loader boundary, train step) call
:func:`hit`, which is a near-free no-op while the registry is empty.

Spec grammar (comma-separated entries, colon-separated fields)::

    point[:key=value]...

    ckpt_write:p=1:at=2          # 2nd checkpoint leaf write raises
    sigterm:step=7               # SIGTERM self when train step == 7
    loader:exc=OSError           # data fetch raises OSError
    train_step:step=3:exc=RuntimeError
    ckpt_write:step=8:kill=9     # SIGKILL mid-save of checkpoint 8

Trigger keys (an entry fires when ALL of its conditions hold):

- ``at=N``    — the Nth invocation of this point (1-based, per process)
- ``step=N``  — the caller-supplied ``step`` context equals N
- ``p=X``     — probability per call, seeded RNG (``seed=``) so a given
  spec replays identically; ``p=1`` fires always
- no condition keys → fires on every call

Action keys (first present wins):

- ``sleep=MS`` — ``time.sleep(MS/1000)`` then return normally: a
  latency fault, not a failure. The call site proceeds as if nothing
  happened, just late — the action the serving flight deck's latency
  -attribution drills inject (a slow chunk, a slow COW copy, a slow
  verify) without killing the sequence
- ``exc=Name`` — raise that builtin exception (default RuntimeError)
- ``kill=SIG`` — ``os.kill(self, SIG)`` (number or name, e.g. ``9``,
  ``KILL``, ``SIGTERM``)
- ``exit=N``   — ``os._exit(N)`` (no cleanup, like a hard crash)
- none         — the ``sigterm`` point self-delivers SIGTERM; every
  other point raises RuntimeError

**Value faults** (numerical chaos, no exception): the points
``nonfinite_grad`` and ``loss_spike`` do not act at the call site —
they return a multiplier that the train step compiles into its graph
(gradients × NaN, loss × spike factor), exercising the skip-step
guard and the divergence watchdog. ``mul=X`` overrides the default
multiplier (NaN for nonfinite_grad, 1e6 for loss_spike). The trigger
keys (``at=``/``step=``/``p=``) work unchanged; ``step=`` matches the
trainer's global step (set via :func:`set_step_context` by the
training loop, a host count: never a device value).

**LLM serving points** (``SERVING_POINTS``): the serving plane calls
:func:`hit` at ``llm_prefill`` (engine prefill entry, once per
sequence (re-)admission), ``llm_chunk_prefill`` (every prefill chunk
under ``FLAGS_prefill_chunk_tokens`` — hits mid-prompt, where
``llm_prefill`` cannot), ``llm_decode`` (decode growth, per sequence
per step), ``llm_spec_verify`` (speculative decode: per sequence per
step before its draft window is proposed/verified — the
``llm_decode`` analog of the FLAGS_speculative_k path),
``llm_cow_copy`` (engine copy-on-write: before the in-pool copy that
privatizes a shared block), ``kv_alloc`` (paged allocator
allocate/extend), and
``llm_chunk_write`` (before each streamed token frame). An exception
at any of these terminates
exactly one sequence/stream (error frame or cancel, blocks freed);
the engine and serving loop survive — the property the serving chaos
drills assert.

Every fired fault increments ``faults_injected_total{point=}`` and
records a forced flight-recorder event before acting, so a drill can
assert the injection actually happened.

Counterpart of ``paddle_tpu.testing.faults``: the same grammar, points,
seeded ``p=`` firing sequence and counter. In the port's captured
``TrainStep`` the value multipliers are two fp32 device scalars written
in place before each replay (see ``static.TrainStep``).
"""

from __future__ import annotations

import builtins
import os
import random
import signal
import threading
from dataclasses import dataclass
from typing import List, Optional

from ..flags import GLOBAL_FLAGS
from ..observability import flight as _flight
from ..observability import metrics as _metrics

__all__ = ["FaultSpec", "parse_spec", "format_spec", "configure",
           "active", "hit", "value_mult", "value_points_armed",
           "set_step_context", "VALUE_POINTS", "SERVING_POINTS"]

# in-graph value-fault points: they never raise/kill; the train step
# consumes their multiplier (grads x NaN / loss x spike factor)
VALUE_POINTS = ("nonfinite_grad", "loss_spike")

# LLM serving plane injection points (serving_llm/ + kv_cache);
# firing any of them fails ONE sequence, never the serving loop
SERVING_POINTS = ("llm_prefill", "llm_chunk_prefill", "llm_decode",
                  "llm_spec_verify", "llm_cow_copy",
                  "llm_chunk_write", "kv_alloc")
_VALUE_DEFAULT_MUL = {"nonfinite_grad": float("nan"),
                      "loss_spike": 1e6}


@dataclass
class FaultSpec:
    point: str
    p: Optional[float] = None
    at: Optional[int] = None
    step: Optional[int] = None
    exc: Optional[str] = None
    kill: Optional[int] = None
    exit: Optional[int] = None
    mul: Optional[float] = None
    sleep: Optional[float] = None  # milliseconds
    seed: int = 0


_INT_KEYS = ("at", "step", "exit", "seed")


def _parse_signal(text: str) -> int:
    text = text.strip()
    if text.lstrip("-").isdigit():
        return int(text)
    name = text.upper()
    if not name.startswith("SIG"):
        name = "SIG" + name
    sig = getattr(signal, name, None)
    if sig is None:
        raise ValueError(f"fault spec: unknown signal {text!r}")
    return int(sig)


def parse_spec(text: Optional[str]) -> List[FaultSpec]:
    """Parse a ``FLAGS_fault_spec`` string into :class:`FaultSpec` list.

    Raises ``ValueError`` on malformed entries — a typo'd chaos spec
    must fail loudly at arm time, not silently never fire.
    """
    specs: List[FaultSpec] = []
    for entry in (text or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        fields = entry.split(":")
        point = fields[0].strip()
        if not point or "=" in point:
            raise ValueError(
                f"fault spec entry {entry!r}: first field must be the "
                "injection point name")
        kwargs = {}
        for f in fields[1:]:
            if "=" not in f:
                raise ValueError(
                    f"fault spec entry {entry!r}: field {f!r} is not "
                    "key=value")
            k, v = f.split("=", 1)
            k, v = k.strip(), v.strip()
            if k == "p":
                kwargs["p"] = float(v)
            elif k == "mul":
                kwargs["mul"] = float(v)
            elif k == "sleep":
                kwargs["sleep"] = float(v)
            elif k in _INT_KEYS:
                kwargs[k] = int(v)
            elif k == "kill":
                kwargs["kill"] = _parse_signal(v)
            elif k == "exc":
                kwargs["exc"] = v
            else:
                raise ValueError(
                    f"fault spec entry {entry!r}: unknown key {k!r} "
                    f"(known: p, at, step, exc, kill, exit, mul, "
                    f"sleep, seed)")
        specs.append(FaultSpec(point, **kwargs))
    return specs


def format_spec(specs: List[FaultSpec]) -> str:
    """Inverse of :func:`parse_spec` (round-trips)."""
    parts = []
    for s in specs:
        fields = [s.point]
        if s.p is not None:
            fields.append(f"p={s.p:g}")
        if s.at is not None:
            fields.append(f"at={s.at}")
        if s.step is not None:
            fields.append(f"step={s.step}")
        if s.exc is not None:
            fields.append(f"exc={s.exc}")
        if s.kill is not None:
            fields.append(f"kill={s.kill}")
        if s.exit is not None:
            fields.append(f"exit={s.exit}")
        if s.mul is not None:
            fields.append(f"mul={s.mul:g}")
        if s.sleep is not None:
            fields.append(f"sleep={s.sleep:g}")
        if s.seed:
            fields.append(f"seed={s.seed}")
        parts.append(":".join(fields))
    return ",".join(parts)


def _exc_class(name: str):
    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    return RuntimeError


class _Armed:
    def __init__(self, spec: FaultSpec) -> None:
        self.spec = spec
        self.calls = 0
        self.rng = random.Random(spec.seed)


class FaultRegistry:
    """Armed spec entries + per-entry invocation counters."""

    def __init__(self, specs: List[FaultSpec]) -> None:
        self._armed = [_Armed(s) for s in specs]
        self._lock = threading.Lock()

    def _match(self, point: str, step: Optional[int]
               ) -> Optional[FaultSpec]:
        """Condition check shared by action and value faults. EVERY
        entry armed on this point advances its call counter on every
        call — even after an earlier entry already fired — so a run of
        entries `p:at=4,p:at=5,p:at=6` fires on three CONSECUTIVE
        calls (the shape a divergence-streak drill needs). The first
        firing entry wins."""
        fire: Optional[FaultSpec] = None
        with self._lock:
            for a in self._armed:
                s = a.spec
                if s.point != point:
                    continue
                a.calls += 1
                if fire is not None:
                    continue
                if s.at is not None and a.calls != s.at:
                    continue
                if s.step is not None and (step is None
                                           or int(step) != s.step):
                    continue
                if s.p is not None and s.p < 1.0 \
                        and a.rng.random() >= s.p:
                    continue
                fire = s
        return fire

    def points(self) -> set:
        with self._lock:
            return {a.spec.point for a in self._armed}

    def hit(self, point: str, step: Optional[int] = None) -> None:
        fire = self._match(point, step)
        if fire is not None:
            self._fire(point, fire, step)

    def value_mult(self, point: str,
                   step: Optional[int] = None) -> float:
        """Multiplier for an in-graph value fault: 1.0 when nothing
        fires, else the entry's ``mul`` (or the point's default).
        Telemetry fires like hit(), but no exception/signal."""
        s = self._match(point, step)
        if s is None:
            return 1.0
        _note(point, s, step)
        mul = s.mul if s.mul is not None \
            else _VALUE_DEFAULT_MUL.get(point, float("nan"))
        return float(mul)

    def _fire(self, point: str, s: FaultSpec,
              step: Optional[int]) -> None:
        _note(point, s, step)
        if s.sleep is not None:
            _injected_wedge_sleep(s.sleep)
            return
        where = f"fault injected at {point!r}" + (
            f" (step {step})" if step is not None else "")
        if s.exc is not None:
            raise _exc_class(s.exc)(where)
        if s.kill is not None:
            os.kill(os.getpid(), s.kill)
            return
        if s.exit is not None:
            os._exit(s.exit)
        if point == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        raise RuntimeError(where)


def _injected_wedge_sleep(ms: float) -> None:
    """The ``sleep=MS`` latency action: delay, then let the call site
    proceed. A dedicated function so an injected wedge has a stable,
    nameable stack frame (``faults.py:_injected_wedge_sleep``) a stack
    diagnosis can point at when the stall was ours."""
    import time
    time.sleep(ms / 1e3)


def _note(point: str, s: FaultSpec, step: Optional[int]) -> None:
    # telemetry first: the action may not return
    _metrics.counter(
        "faults_injected_total",
        "faults fired by the chaos injection registry "
        "(paddle_tpu.testing.faults, FLAGS_fault_spec)",
        always=True).inc(point=point)
    _flight.record("fault_injected", force=True, point=point,
                   step=step, spec=format_spec([s]))


_REGISTRY: Optional[FaultRegistry] = None


def configure(spec: Optional[str]) -> None:
    """(Re)arm the registry from a spec string; ``None``/"" disarms.
    Wired to FLAGS_fault_spec's on_change hook."""
    global _REGISTRY
    specs = parse_spec(spec) if spec else []
    _REGISTRY = FaultRegistry(specs) if specs else None


def active() -> bool:
    return _REGISTRY is not None


def hit(point: str, step: Optional[int] = None) -> None:
    """Injection-point hook: no-op unless a spec armed this point."""
    r = _REGISTRY
    if r is None:
        return
    r.hit(point, step=step)


# global-step context for value faults: the training loop publishes its
# step counter here so spec `step=` triggers match the trainer's
# notion of a step even from inside TrainStep
_step_context: Optional[int] = None


def set_step_context(step: Optional[int]) -> None:
    global _step_context
    _step_context = step


def value_points_armed() -> bool:
    """True when the armed spec contains any in-graph value-fault
    entry (nonfinite_grad / loss_spike) — train steps consult this
    once per call to decide whether to thread fault multipliers
    through the compiled batch."""
    r = _REGISTRY
    if r is None:
        return False
    return bool(r.points() & set(VALUE_POINTS))


def value_mult(point: str, step: Optional[int] = None) -> float:
    """Current multiplier for a value-fault point (1.0 = inert).
    ``step`` defaults to the training loop's published step context."""
    r = _REGISTRY
    if r is None:
        return 1.0
    if step is None:
        step = _step_context
    return r.value_mult(point, step=step)


# Arm from an env-set FLAGS_fault_spec at import (the subprocess-drill
# path: the drill exports FLAGS_fault_spec before the trainer starts).
# ptlint: disable=flag-freeze -- deliberate: the subprocess drill exports FLAGS_fault_spec before the trainer starts, so arming at import is the contract
if GLOBAL_FLAGS.get("fault_spec"):
    # ptlint: disable=flag-freeze -- the same deliberate import-time read: the spec the drill exported is the one armed
    configure(GLOBAL_FLAGS.get("fault_spec"))
