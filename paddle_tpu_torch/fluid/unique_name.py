"""``fluid.unique_name`` (ref: python/paddle/fluid/unique_name.py):
process-wide unique names with guard/switch scoping."""

from __future__ import annotations

import contextlib
import threading


class _Generator:
    """(ref: unique_name.py:25 UniqueNameGenerator) an optional prefix
    before every generated name."""

    def __init__(self, prefix: str = "") -> None:
        self._counts: dict = {}
        self._lock = threading.Lock()
        self.prefix = prefix or ""

    def __call__(self, key: str) -> str:
        with self._lock:
            n = self._counts.get(key, 0)
            self._counts[key] = n + 1
        return f"{self.prefix}{key}_{n}"


_generator = _Generator()


def generate(key: str) -> str:
    return _generator(key)


def switch(new_generator=None):
    """Replaces the generator; returns the old one (ref switch())."""
    global _generator
    old = _generator
    _generator = new_generator if new_generator is not None \
        else _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    """(ref: unique_name.py guard) a str/bytes argument is a name PREFIX
    for the guarded block; a generator is used as it is."""
    if isinstance(new_generator, bytes):
        new_generator = new_generator.decode()
    if isinstance(new_generator, str):
        new_generator = _Generator(new_generator)
    elif new_generator is not None and not isinstance(new_generator,
                                                      _Generator):
        raise TypeError(
            f"unique_name.guard expects a str/bytes prefix or a "
            f"generator, got {type(new_generator).__name__}")
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
