"""Captured-program analytics: per-signature program cards.

Counterpart of ``paddle_tpu.observability.xprof``: the same registry
(``cards()``, one card per step name and input signature, keyed like the
capture tracker), the same ``harvest``/``flops_of`` entry points, card
keys and gauges (``program_flops{fn=}``, ``program_peak_bytes{fn=}``,
``program_harvest_seconds{fn=}``), read by ``/varz``, ``metrics.json``
and a training loop's achieved-FLOP/s arithmetic.

The JAX card is XLA's cost and memory analysis of the compiled program.
The port has no compiler cost model, so its card is measured on the step
itself, once per signature, at the capture (the port's counterpart of a
trace), never by running an extra step (a second run would apply the
optimizer update twice):

- **FLOPs** — a dispatch mode counting with
  ``torch.utils.flop_counter``'s formulas over the eager warm-up step that ``static.TrainStep``/``EvalStep`` already run
  before they capture, plus the work of the hand-written CUDA kernels,
  which are called through ``ctypes`` where the counter cannot see them:
  each kernel wrapper reports its own products (:func:`add_kernel_flops`,
  the formulas of ``chip_smoke.py``'s bounds, recomputed products
  included: the card counts the work the step does). On the CPU the
  plain versions run instead and the counter sees their products.
- **Memory** — the peak allocated bytes around the warm-up and the
  capture, from the caching allocator's host-side statistics
  (``max_memory_allocated``), without resetting the process-wide peak
  that other readers own. When the window did not raise that peak, the
  card reports the process's high-water mark (an upper bound) and says
  so in ``memory_analysis["peak_scope"]``.
- **Bytes accessed** — not counted (no cost model over the CUDA
  kernels): the card carries the JAX ``unavailable`` marker for it.

Gated like the JAX harvest on BOTH ``FLAGS_enable_metrics`` and
``FLAGS_program_analytics``: a capture-time cost only, nothing per
replay.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from ..flags import GLOBAL_FLAGS
from . import metrics as _metrics

__all__ = ["ProgramCardRegistry", "cards", "enabled", "harvest",
           "flops_of", "counting", "add_kernel_flops", "Harvest"]

BYTES_UNAVAILABLE = ("bytes accessed: not counted (the port has no cost "
                     "model over its CUDA kernels)")


def enabled() -> bool:
    """Program analytics run only when metrics are on AND the dedicated
    flag is on."""
    return _metrics.enabled() and bool(GLOBAL_FLAGS.get("program_analytics"))


class ProgramCardRegistry:
    """name -> {signature -> card} store (mirrors the capture tracker's
    keying so cards and capture records line up in /varz)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cards: Dict[str, Dict[str, Dict[str, Any]]] = {}  # guarded-by: self._lock

    def put(self, name: str, signature: str,
            card: Dict[str, Any]) -> None:
        with self._lock:
            self._cards.setdefault(name, {})[signature] = card

    def get(self, name: str) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._cards.get(name, {}))

    def latest(self, name: str) -> Optional[Dict[str, Any]]:
        """Most recently harvested card for a step (insertion order), or
        None."""
        with self._lock:
            by_sig = self._cards.get(name)
            if not by_sig:
                return None
            return list(by_sig.values())[-1]

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        with self._lock:
            return {n: dict(sigs) for n, sigs in self._cards.items()}

    def reset(self) -> None:
        with self._lock:
            self._cards.clear()


_CARDS = ProgramCardRegistry()


def cards() -> ProgramCardRegistry:
    return _CARDS


# -- the hand-written kernels' FLOPs ------------------------------------------

# harvests counting right now (the kernel wrappers' fast path reads it)
_active_lock = threading.Lock()
_ACTIVE: list = []  # guarded-by: _active_lock


class _FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of every op dispatched under it with
    ``torch.utils.flop_counter``'s formulas (matrix products,
    convolutions, attention), by op name. Unlike ``FlopCounterMode`` it
    neither decomposes an op nor tracks modules (whose gradient hooks
    ``autograd.grad`` over leaves refuses): every op runs exactly as it
    would without it."""

    def __init__(self) -> None:
        super().__init__()
        self.by_op: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, flops: int) -> None:
        with self._lock:
            self.by_op[name] = self.by_op.get(name, 0) + int(flops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.add(str(func._overloadpacket),
                     formula(*args, **kwargs, out_val=out))
        return out


def _counters_in_this_thread() -> list:
    """The flop counters on this thread's dispatch-mode stack (the
    autograd engine carries the stack into its backward threads)."""
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, _FlopCounter)]


def counting() -> bool:
    """Whether any harvest is counting FLOPs right now: a kernel wrapper
    tests this before it works out its launch's FLOPs."""
    return bool(_ACTIVE)


def add_kernel_flops(name: str, flops: float) -> None:
    """A hand-written kernel's launch adds its ``flops`` (under its
    ``name``) to the harvest counting on this thread, if any: the
    kernels run through ``ctypes``, where the dispatch mode cannot see
    them. One list test when no harvest is counting."""
    if not _ACTIVE:
        return
    for c in _counters_in_this_thread():
        c.add(name, flops)


class Harvest:
    """One card in the making: ``counting()`` wraps the warm-up step (the
    FLOPs), the window from construction to :meth:`finish` (the warm-up
    and the capture) gives the memory peak."""

    def __init__(self, name: str, signature: str,
                 device: Optional[torch.device] = None) -> None:
        self.name = name
        self.signature = signature
        self.device = device
        self.counter: Optional[_FlopCounter] = None
        self._t0 = time.perf_counter()
        self._counting_s = 0.0
        self._peak_before = self._peak()

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _peak(self) -> Optional[int]:
        # host-side allocator statistics only: legal while another
        # thread captures
        if not self._on_card():
            return None
        return int(torch.cuda.max_memory_allocated(self.device))

    @contextlib.contextmanager
    def counting(self):
        """Counts the FLOPs of the code inside (the eager warm-up)."""
        t0 = time.perf_counter()
        self.counter = _FlopCounter()
        with _active_lock:
            _ACTIVE.append(self)
        try:
            with self.counter:
                yield
        finally:
            with _active_lock:
                _ACTIVE.remove(self)
            self._counting_s += time.perf_counter() - t0

    def finish(self) -> Dict[str, Any]:
        """Records the card (after the capture) and publishes its
        gauges."""
        card: Dict[str, Any] = {"fn": self.name,
                                "signature": self.signature,
                                "harvested_unix": time.time(),
                                "device": str(self.device)}
        cost: Dict[str, float] = {}
        if self.counter is not None:
            by_op = dict(self.counter.by_op)
            kernels = sum(v for k, v in by_op.items()
                          if not k.startswith("aten."))
            total = float(sum(by_op.values()))
            cost = {"flops": total,
                    "flops_torch_ops": total - float(kernels),
                    "flops_cuda_kernels": float(kernels)}
            card["flops_by_op"] = by_op
        mem: Dict[str, Any] = {}
        after = self._peak()
        if after is not None:
            mem = {"peak_allocated_bytes": after,
                   "peak_scope": "window" if after > self._peak_before
                   else "process"}
        card["cost_analysis"] = cost
        card["memory_analysis"] = mem
        card["unavailable"] = BYTES_UNAVAILABLE
        if "flops" in cost:
            card["flops"] = cost["flops"]
        if mem:
            card["peak_bytes_estimate"] = mem["peak_allocated_bytes"]
        card["counting_seconds"] = self._counting_s
        card["harvest_seconds"] = time.perf_counter() - self._t0
        _record(self.name, self.signature, card)
        return card


def _record(name: str, signature: str, card: Dict[str, Any]) -> None:
    _CARDS.put(name, signature, card)
    # gauges so the card headline numbers ride the Prometheus page
    if "flops" in card:
        _metrics.gauge(
            "program_flops",
            "counted FLOPs of the latest captured step signature "
            "(program card)"
        ).set(card["flops"], fn=name)
    if "peak_bytes_estimate" in card:
        _metrics.gauge(
            "program_peak_bytes",
            "peak allocated bytes around the latest capture (program "
            "card)"
        ).set(float(card["peak_bytes_estimate"]), fn=name)
    _metrics.histogram(
        "program_harvest_seconds",
        "wall time of program-card harvests (capture-time only)",
        buckets=(0.01, 0.05, 0.1, 0.5, 1, 5, 30, 120)
    ).observe(card["harvest_seconds"], fn=name)


def harvest(name: str, run: Callable[[], Any], signature: str,
            device: Optional[torch.device] = None) -> Any:
    """Runs ``run()`` (a step's first, eager call) under a card's FLOP
    counter and records the card; returns ``run()``'s result. The
    capture-time entry point of a step that captures nothing after its
    first call."""
    h = Harvest(name, signature, device)
    with h.counting():
        out = run()
    h.finish()
    return out


def flops_of(name: str) -> Optional[float]:
    """Counted FLOPs of the latest card for ``name`` (None when there is
    no card or it has no count) — the numerator of a training loop's
    achieved FLOP/s."""
    card = _CARDS.latest(name)
    if not card:
        return None
    v = card.get("flops")
    return float(v) if v else None
