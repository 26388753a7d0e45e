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
  ``default`` binding, else the global generator of that device.

The bits differ from JAX's threefry streams, so dropout outside the
flash-attention kernels (whose mask is a hash of the seed) cannot match
the JAX package bit for bit; parity tests run that dropout at 0.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch

__all__ = ["seed", "default_generator", "rng_scope", "next_generator"]

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


def next_generator(stream: str = "default",
                   device="cpu") -> torch.Generator:
    """The generator bound to ``stream`` (else to ``default``) by the
    innermost ``rng_scope``, else the global generator of ``device``."""
    streams = _scope.streams
    if streams is not None:
        gen = streams.get(stream, streams.get("default"))
        if gen is not None:
            return gen
    return default_generator(device)

