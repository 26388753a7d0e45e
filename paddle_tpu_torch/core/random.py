"""Random number state of the PyTorch package.

Counterpart of ``paddle_tpu.core.random``. The JAX package draws keys
from a global generator eagerly and from a bound per-step key stream
under ``rng_scope`` (the train step binds one). Here the streams are
``torch.Generator``s:

- ``seed(n)`` reseeds the global generators (one per device, made on
  first use), as ``paddle.seed`` does;
- ``rng_scope(dropout=gen)`` binds named generators for the code inside
  (``TrainStep`` binds its own generator, seeded once from its ``seed``
  and advanced by every step, as the JAX step splits its ``rng`` key),
  and ``next_generator(stream, device)`` returns the bound one, else the
  ``default`` binding, else the global generator of that device
  (``bound_generator(stream)``: the binding alone, or None).

The bits differ from JAX's threefry streams, so dropout outside the
flash-attention kernels (whose mask is a hash of the seed) cannot match
the JAX package bit for bit; parity tests run that dropout at 0.

Every random draw of the ported layers (a dropout keep mask, a flash
kernel's seed) goes through ``draw(stream, device, fn)``, so a stretch
of code can be run twice with the same draws: ``replay_draws(tape)``
records the draws of its first run on ``tape`` and hands them back, in
order, to every later run, which draws nothing. That is the
rematerialisation's counterpart of the JAX remat replaying its traced
keys (``transformer_remat``): the recompute in the backward sees the
forward's masks and seeds, and the generators advance once, as without
the recompute. It holds device tensors only, so it works inside a CUDA
graph capture, where a generator's ``get_state``/``set_state`` cannot
run; and it binds per thread, as the recompute runs on the autograd
engine's thread.

``use_fast_rng`` (the JAX package's switch to the TPU's hardware PRNG)
is accepted and changes nothing (``fast_rng_enabled``): Philox is
counter-based already.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from ..flags import GLOBAL_FLAGS

__all__ = ["seed", "default_generator", "rng_scope", "next_generator",
           "bound_generator", "DrawTape", "replay_draws", "draw",
           "fast_rng_enabled"]

_lock = threading.Lock()
_seed = 0
_globals: Dict[torch.device, torch.Generator] = {}


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def seed(value: int) -> None:
    """Global seed: every device's global generator restarts from it."""
    global _seed
    with _lock:
        _seed = int(value)
        for dev, gen in _globals.items():
            gen.manual_seed(_seed)


def default_generator(device="cpu") -> torch.Generator:
    """The global generator of ``device``, seeded by the last ``seed()``."""
    dev = _canonical(device)
    with _lock:
        gen = _globals.get(dev)
        if gen is None:
            gen = _globals[dev] = torch.Generator(device=dev).manual_seed(
                _seed)
        return gen


class _ScopeState(threading.local):
    def __init__(self) -> None:
        self.streams: Optional[Dict[str, torch.Generator]] = None
        self.tape: Optional["DrawTape"] = None


_scope = _ScopeState()


@contextlib.contextmanager
def rng_scope(**generators: torch.Generator) -> Iterator[None]:
    """Bind named generator streams (e.g. ``dropout=gen``) for the code
    inside; the previous binding returns on exit."""
    prev = _scope.streams
    _scope.streams = dict(generators)
    try:
        yield
    finally:
        _scope.streams = prev


def bound_generator(stream: str = "default"
                    ) -> Optional[torch.Generator]:
    """The generator bound to ``stream`` (else to ``default``) by the
    innermost ``rng_scope``, or None outside any scope."""
    streams = _scope.streams
    if streams is None:
        return None
    return streams.get(stream, streams.get("default"))


def next_generator(stream: str = "default",
                   device="cpu") -> torch.Generator:
    """The generator bound to ``stream`` (else to ``default``) by the
    innermost ``rng_scope``, else the global generator of ``device``."""
    gen = bound_generator(stream)
    return gen if gen is not None else default_generator(device)



class DrawTape:
    """The random draws of one stretch of code, in order: recorded by
    its first run under ``replay_draws``, handed back by later runs."""

    def __init__(self) -> None:
        self.draws: List[Any] = []
        self.recorded = False
        self._pos = 0

    def _next(self) -> Any:
        if self._pos >= len(self.draws):
            raise RuntimeError(
                f"replayed code drew more than the {len(self.draws)} "
                f"draws it recorded: its random calls must not depend "
                f"on anything but its inputs")
        out = self.draws[self._pos]
        self._pos += 1
        return out


@contextlib.contextmanager
def replay_draws(tape: DrawTape) -> Iterator[DrawTape]:
    """Binds ``tape`` for the code inside (on this thread): its first
    use records every ``draw``, each later one replays them from the
    start."""
    prev = _scope.tape
    tape._pos = 0
    _scope.tape = tape
    try:
        yield tape
    finally:
        _scope.tape = prev
        tape.recorded = True


def draw(stream: str, device, fn: Callable[[torch.Generator], Any]) -> Any:
    """``fn(next_generator(stream, device))``, the one way the ported
    layers draw random bits; under a recorded ``replay_draws`` tape the
    recorded result instead, drawing nothing."""
    tape = _scope.tape
    if tape is not None and tape.recorded:
        return tape._next()
    out = fn(next_generator(stream, device))
    if tape is not None:
        tape.draws.append(out)
    return out


def fast_rng_enabled() -> bool:
    """The ``use_fast_rng`` flag, for parity only: the port's generators
    are Philox (counter-based) whatever its value."""
    return bool(GLOBAL_FLAGS.get("use_fast_rng"))
