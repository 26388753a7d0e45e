"""ctypes binding of the native serving runtime (the repository's csrc/).

Counterpart of ``paddle_tpu.native``, holding what the serving wire
needs: the loader, :class:`ServingTransport` (the TCP front of
``inference.Server``: sockets, framing, the bounded request queue) and
the monitor counters (``stat_add``/``stat_get``/``stat_reset``/
``stat_dump``), whose ``serving.*`` lines ride the STATS reply.

The library compiles from the repository's ``csrc/*.cc`` with ``g++``
(the JAX package's command) at first use into
``paddle_tpu_torch/_build/libptnative.so``, never into the JAX package.
The build is safe across processes: one build at a time under a file
lock, writing a temporary file that ``os.replace`` moves into place, so
no process loads a half-written library. A hash of the sources and the
command, kept beside the library, decides whether it is stale.

The library has no SONAME, so ``ctypes`` keeps this copy apart from the
JAX package's by path: each copy has its own monitor registry.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = ["build", "loaded", "ServingTransport", "stat_add",
           "stat_get", "stat_reset", "stat_dump"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG.parent / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libptnative.so"
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread"]

_lib = None
_lib_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cc")) + sorted(CSRC.glob("*.h")):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()


def build(out_dir: Optional[os.PathLike] = None) -> str:
    """Compile ``csrc/*.cc`` into ``<out_dir>/libptnative.so`` (default
    ``paddle_tpu_torch/_build``) unless the library there was built from
    the same sources and flags. Returns the library's path."""
    out_dir = Path(out_dir) if out_dir is not None else BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / LIB_NAME
    stamp = out_dir / (LIB_NAME + ".sha256")
    want = _digest()
    with open(out_dir / (LIB_NAME + ".lock"), "w") as lock:
        # threads of one process hold distinct descriptors, so flock
        # serialises them as it does processes
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists() and stamp.exists() \
                    and stamp.read_text() == want:
                return str(lib)
            tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
                   *(str(p) for p in sorted(CSRC.glob("*.cc")))]
            proc = subprocess.run(cmd, cwd=CSRC, capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"native build failed ({' '.join(cmd)})"
                                   f":\n{proc.stderr}")
            os.replace(tmp, lib)
            stamp.write_text(want)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return str(lib)


_SIGS = {
    "pt_srv_start": ([ctypes.c_int, ctypes.c_int], ctypes.c_int64),
    "pt_srv_port": ([ctypes.c_int64], ctypes.c_int),
    "pt_srv_stop": ([ctypes.c_int64], None),
    "pt_srv_next_ex2": ([ctypes.c_int64, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_uint64),
                         ctypes.POINTER(ctypes.c_uint64),
                         ctypes.POINTER(ctypes.c_uint64),
                         ctypes.POINTER(ctypes.c_uint8),
                         ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64],
                        ctypes.c_int64),
    "pt_srv_reply": ([ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
                      ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64],
                     ctypes.c_int),
    "pt_srv_reply_chunk": ([ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                            ctypes.c_int], ctypes.c_int),
    "pt_srv_pending": ([ctypes.c_int64], ctypes.c_int64),
    "pt_srv_stats": ([ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64],
                     ctypes.c_int64),
    "pt_mon_add": ([ctypes.c_char_p, ctypes.c_int64], None),
    "pt_mon_get": ([ctypes.c_char_p], ctypes.c_int64),
    "pt_mon_reset": ([ctypes.c_char_p], None),
    "pt_mon_dump": ([ctypes.c_char_p, ctypes.c_int64], ctypes.c_int64),
}


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def loaded() -> bool:
    """Whether the library is already loaded; never triggers a build
    (``observability.native_stats`` reads through it)."""
    return _lib is not None


def _parse_stats(text: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for line in text.splitlines():
        if "=" in line:
            k, v = line.rsplit("=", 1)
            out[k] = int(v)
    return out


def _bytes_arg(payload: bytes):
    return (ctypes.c_uint8 * max(1, len(payload))).from_buffer_copy(
        payload or b"\0")


class ServingTransport:
    """Native TCP front of the inference server (csrc/serving.cc).

    Owns the sockets, framing and the bounded request queue; the Python
    side (``paddle_tpu_torch.inference.Server``) dequeues payloads, runs
    the engine and posts replies by request id."""

    def __init__(self, port: int = 0, queue_cap: int = 256,
                 max_payload: int = 64 << 20):
        lib = _load()
        self._h = lib.pt_srv_start(port, queue_cap)
        if self._h < 0:
            raise RuntimeError(f"serving transport failed on port {port}")
        self.port = lib.pt_srv_port(self._h)
        self._buf = (ctypes.c_uint8 * max_payload)()
        self._max_payload = max_payload

    def next_request_ex2(self, timeout_ms: int = 100
                         ) -> Optional[Tuple[int, bytes, int, float, bool]]:
        """One (req_id, payload, trace_id, ingress_unix_s, is_stream), or
        None on timeout or shutdown. ``is_stream`` is True for 'PTST'
        streaming-generate frames, answered with ``reply_chunk``
        (possibly many times) instead of ``reply``. Requests above
        ``max_payload`` are error-replied natively and never surface."""
        rid = ctypes.c_uint64(0)
        trace = ctypes.c_uint64(0)
        ingress = ctypes.c_uint64(0)
        stream = ctypes.c_uint8(0)
        n = _load().pt_srv_next_ex2(self._h, timeout_ms, ctypes.byref(rid),
                                    ctypes.byref(trace),
                                    ctypes.byref(ingress),
                                    ctypes.byref(stream), self._buf,
                                    self._max_payload)
        if n <= 0:
            return None
        return (rid.value, ctypes.string_at(self._buf, n), trace.value,
                ingress.value / 1e6, bool(stream.value))

    def reply_chunk(self, req_id: int, payload: bytes, status: int = 0,
                    final: bool = True) -> int:
        """One streaming reply chunk. A non-final chunk keeps the request
        in flight for more chunks on the same tag; the final one closes
        it. Returns the native rc: 0 ok, -1 unknown id, -3 client gone
        (the request is closed then, and the caller cancels the
        sequence). The native side counts every nonzero outcome in
        ``serving.reply_dropped_total``."""
        return _load().pt_srv_reply_chunk(self._h, req_id, status,
                                          _bytes_arg(payload), len(payload),
                                          1 if final else 0)

    def reply(self, req_id: int, payload: bytes, status: int = 0) -> int:
        """One whole reply; the rc as for ``reply_chunk``."""
        return _load().pt_srv_reply(self._h, req_id, status,
                                    _bytes_arg(payload), len(payload))

    def pending(self) -> int:
        return _load().pt_srv_pending(self._h)

    def stats(self) -> Dict[str, int]:
        """The STATS reply's lines (queue depth, inflight, totals,
        uptime, ``serving.*`` monitor lines), read locally."""
        lib = _load()
        need = lib.pt_srv_stats(self._h, None, 0)
        if need <= 0:
            return {}
        buf = ctypes.create_string_buffer(need)
        lib.pt_srv_stats(self._h, buf, need)
        return _parse_stats(buf.raw[:need].decode())

    def stop(self) -> None:
        if self._h > 0:
            _load().pt_srv_stop(self._h)
            self._h = -1

    def __del__(self):
        if getattr(self, "_h", -1) > 0 and _lib is not None:
            _lib.pt_srv_stop(self._h)
            self._h = -1


def stat_add(name: str, value: int = 1) -> None:
    _load().pt_mon_add(name.encode(), value)


def stat_get(name: str) -> int:
    return _load().pt_mon_get(name.encode())


def stat_reset(name: str) -> None:
    _load().pt_mon_reset(name.encode())


def stat_dump() -> Dict[str, int]:
    lib = _load()
    need = lib.pt_mon_dump(None, 0)
    if need <= 0:
        return {}
    buf = ctypes.create_string_buffer(need)
    lib.pt_mon_dump(buf, need)
    return _parse_stats(buf.raw[:need].decode())
