"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``_build/<name>-<hash>.so``, which ``ctypes`` loads. The hash covers
the source text, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header rebuilds and an unchanged one is reused.
Building happens at first use (never at import), and ``build_all()``
starts one ``nvcc`` per source at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check()`` raises on a non-zero code. A failed build or launch raises:
nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "library", "check",
           "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# the CUDA toolkit's default install prefix
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

# kernel library name -> its C entry points' ctypes signatures
_P, _I, _F, _U, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_uint, ctypes.c_longlong
# flash attention's trailing arguments: dims (a host int64 array), scale,
# causal, keep_prob, threshold, stream
_FLASH_TAIL = [_P, _F, _I, _F, _U, _P]
SOURCES: Dict[str, Dict[str, list]] = {
    "layer_norm": {
        # x, w, b, y, rows, cols, eps, stream
        "layer_norm_fwd": [_P, _P, _P, _P, _I, _I, _F, _P],
    },
    "paged_attention": {
        # q, k_pool, v_pool, tables, lens, out, part, tickets,
        # B, H, D, n_blocks, block_size, max_blocks, chunk, scale, stream
        "paged_attention_fwd": [_P] * 8 + [_I] * 7 + [_F, _P],
        # q, q_lens, k_pool, v_pool, tables, lens, out, part, tickets,
        # B, Qmax, H, D, n_blocks, block_size, max_blocks, chunk, scale,
        # stream
        "paged_attention_mq_fwd": [_P] * 9 + [_I] * 8 + [_F, _P],
    },
    "flash_attention": {
        # q, k, v, bias, seed, out, lse, ...tail
        "flash_attention_fwd": [_P] * 7 + _FLASH_TAIL,
        # q, k, v, dout, lse, delta, bias, seed, dq, ...tail
        "flash_attention_bwd_dq": [_P] * 9 + _FLASH_TAIL,
        # q, k, v, dout, lse, delta, bias, seed, dk, dv, ...tail
        "flash_attention_bwd_dkv": [_P] * 10 + _FLASH_TAIL,
        # q, k, v, dout, lse, delta, bias, seed, dq, dk, dv, ...tail
        "flash_attention_bwd_fused": [_P] * 11 + _FLASH_TAIL,
    },
    "fused_softmax_xent": {
        # h, w, bias, labels, part, loss, lse, N, V, H, splits,
        # ignore_index, stream
        "fused_xent_fwd": [_P] * 7 + [_I, _I, _I, _I, _L, _P],
        # h, w, bias, labels, lse, g, dlog, N, V, H, v0, vc, Vc,
        # ignore_index, stream
        "fused_xent_bwd_dlog": [_P] * 7 + [_I] * 6 + [_L, _P],
        # dlog, h, dw, db, N, H, v0, vc, Vc, stream
        "fused_xent_bwd_dw": [_P] * 4 + [_I] * 5 + [_P],
        # dlog, w, dh, N, H, v0, vc, Vc, accumulate, stream
        "fused_xent_bwd_dh": [_P] * 3 + [_I] * 6 + [_P],
    },
    "fused_adam": {
        # table, n_leaves, n_chunks, lr_c, ok, lr * wd on the device (or
        # null), b1, 1 - b1, b2, 1 - b2, eps, lr * wd, weight_decay,
        # variant, stream
        "fused_adam_multi": [_P, _I, _I, _P, _P, _P] + [_F] * 7 + [_I, _P],
    },
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, shared memory, spills) per library
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the
    toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    # the source, the headers every source may include, and the flags
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built.
    Writes to a per-process temporary name; ``_finish`` renames it into
    place, so concurrent builds never load a half-written file."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp_path, _target(name))  # type: ignore[attr-defined]


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_all(names: Optional[List[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Build (one nvcc per source, all running at once) and load every
    kernel library. Returns {name: library}."""
    names = list(names or SOURCES)
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = [(n, _start(n)) for n in todo]
        errors = []
        for n, p in procs:  # wait for every nvcc before raising
            try:
                _finish(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in todo:
            _libs[n] = _load(n)
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all([name])[name]
    return lib


def check(name: str, code: int, what: str) -> None:
    """Raise if a C entry point of library ``name`` returned a CUDA
    error code (a refused or faulted launch)."""
    if code != 0:
        msg = library(name).cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA launch of {what} failed: error {code} "
                           f"({msg})")
