"""Build-integration paths and the persistent kernel-library cache.

Counterpart of ``paddle_tpu.sysconfig`` (ref: python/paddle/
sysconfig.py get_include/get_lib, where extension authors find the
native headers and shared library). The native surface is the C API in
``csrc/ptnative.h`` and ``libptnative.so``, which ``native.build()``
compiles from ``csrc/*.cc``.

The port's persistent compiled artefacts are the ``nvcc``-built kernel
libraries (``kernels/_build.py``: ``csrc/<name>.cu`` -> ``<name>-
<digest>.so``, the digest over the source, the shared headers and the
flags). ``enable_compile_cache(dir)`` points their build directory at
``dir``, so a second process with the same directory loads them instead
of compiling; ``compile_cache_stats()`` counts this process's libraries
found built (hits) and compiled (misses). ``apply_compile_cache_flag``
reads ``FLAGS_compile_cache_dir``: setting the flag applies it, and the
kernel build applies an environment value before it builds.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["get_include", "get_lib", "enable_compile_cache",
           "apply_compile_cache_flag", "compile_cache_stats"]

_FLAG_APPLIED_DIR: Optional[str] = None


def get_include() -> str:
    """The directory holding ``ptnative.h`` (the checkout's ``csrc/``)."""
    from .native import CSRC
    if (CSRC / "ptnative.h").is_file():
        return str(CSRC)
    raise FileNotFoundError(
        f"no native headers found: {CSRC / 'ptnative.h'} is missing "
        "(a checkout with csrc/ is needed)")


def get_lib() -> str:
    """The directory holding ``libptnative.so`` (built on first use)."""
    from . import native
    return os.path.dirname(native.build())


def enable_compile_cache(cache_dir: Optional[str] = None,
                         min_compile_secs: float = 0.5) -> None:
    """Builds and loads the kernel libraries from ``cache_dir`` (default:
    the package's ``_build/``), created if missing. Libraries already
    loaded in this process stay loaded. ``min_compile_secs`` is accepted
    for the JAX signature: every library is kept, as each is a
    whole-file nvcc compile."""
    from .kernels import _build
    if cache_dir is None:
        cache_dir = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)


def compile_cache_stats() -> dict:
    """``{'hits': int, 'misses': int}``: the kernel libraries this
    process found built in the build directory, and those it compiled."""
    from .kernels import _build
    return dict(_build.cache_stats)


def apply_compile_cache_flag() -> None:
    """Points the kernel build at ``FLAGS_compile_cache_dir`` if set.
    Idempotent and cheap."""
    global _FLAG_APPLIED_DIR
    from .flags import GLOBAL_FLAGS
    cache_dir = GLOBAL_FLAGS.get("compile_cache_dir")
    if not cache_dir or cache_dir == _FLAG_APPLIED_DIR:
        return
    _FLAG_APPLIED_DIR = cache_dir
    enable_compile_cache(cache_dir)
