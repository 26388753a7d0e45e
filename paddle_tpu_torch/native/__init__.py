"""ctypes binding of the native runtime (the repository's csrc/).

Counterpart of ``paddle_tpu.native``, holding what the serving wire and
the file-driven data path need: the loader, :class:`ServingTransport`
(the TCP front of ``inference.Server``: sockets, framing, the bounded
request queue), the monitor counters (``stat_add``/``stat_get``/
``stat_reset``/``stat_dump``), whose ``serving.*`` lines ride the STATS
reply, :class:`SlotSpec`/:class:`NativeDataFeed` (``csrc/data_feed.cc``:
reader threads parse MultiSlot files into records, which stream into
batches or load into memory for a seeded local shuffle; the records of a
range serialise for an exchange), under ``data.dataset``, and the job's
control plane (``csrc/control_plane.cc``): :class:`ControlPlaneServer`, a
key/value and barrier server that ``distributed.launch`` runs for rank 0's
job, and :class:`ControlPlaneClient`, which the ranks reach it with
(``InMemoryDataset.global_shuffle`` exchanges records through it), and
the parameter server (``csrc/ps_service.cc``): :class:`PsServer`, a shard
of dense and sparse tables with server-side optimizers and worker
heartbeats, and :class:`PsClient` (``distributed.ps`` drives them), and
:class:`Tokenizer` (``csrc/tokenizer.cc``: threaded frequency counting
over corpus files, whitespace encoding to ids; ``datasets.Imikolov``
builds its vocabulary through it).

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["build", "available", "loaded", "ServingTransport", "stat_add",
           "stat_get", "stat_reset", "stat_dump", "SlotSpec",
           "NativeDataFeed", "ControlPlaneServer", "ControlPlaneClient",
           "Tokenizer"]

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
    "pt_df_create": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int], ctypes.c_int64),
    "pt_df_destroy": ([ctypes.c_int64], None),
    "pt_df_set_files": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int),
    "pt_df_start": ([ctypes.c_int64], ctypes.c_int),
    "pt_df_load_into_memory": ([ctypes.c_int64], ctypes.c_int64),
    "pt_df_local_shuffle": ([ctypes.c_int64, ctypes.c_uint64], None),
    "pt_df_start_from_memory": ([ctypes.c_int64], ctypes.c_int),
    "pt_df_serialize_range": ([ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint8),
                               ctypes.c_int64], ctypes.c_int64),
    "pt_df_deserialize_append": ([ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int64], ctypes.c_int64),
    "pt_df_memory_size": ([ctypes.c_int64], ctypes.c_int64),
    "pt_df_clear_memory": ([ctypes.c_int64], None),
    "pt_df_next": ([ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_void_p),
                    ctypes.POINTER(ctypes.c_void_p)], ctypes.c_int),
    "pt_cp_server_start": ([ctypes.c_int], ctypes.c_int64),
    "pt_cp_server_port": ([ctypes.c_int64], ctypes.c_int),
    "pt_cp_server_stop": ([ctypes.c_int64], None),
    "pt_cp_client_connect": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int],
                             ctypes.c_int64),
    "pt_cp_client_close": ([ctypes.c_int64], None),
    "pt_cp_set": ([ctypes.c_int64, ctypes.c_char_p,
                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64],
                  ctypes.c_int),
    "pt_cp_get": ([ctypes.c_int64, ctypes.c_char_p,
                   ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int], ctypes.c_int64),
    "pt_cp_add": ([ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64],
                  ctypes.c_int64),
    "pt_cp_barrier": ([ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
                       ctypes.c_int], ctypes.c_int),
    "pt_ps_server_start": ([ctypes.c_int], ctypes.c_int64),
    "pt_ps_server_port": ([ctypes.c_int64], ctypes.c_int),
    "pt_ps_server_stop": ([ctypes.c_int64], None),
    "pt_ps_connect": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int],
                      ctypes.c_int64),
    "pt_ps_disconnect": ([ctypes.c_int64], None),
    "pt_ps_dense_init": ([ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int],
                         ctypes.c_int),
    "pt_ps_dense_pull": ([ctypes.c_int64, ctypes.c_char_p,
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                          ctypes.c_int64, ctypes.c_int], ctypes.c_int64),
    "pt_ps_dense_push": ([ctypes.c_int64, ctypes.c_char_p,
                          ctypes.POINTER(ctypes.c_float), ctypes.c_int64],
                         ctypes.c_int64),
    "pt_ps_sparse_init": ([ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                           ctypes.c_float], ctypes.c_int),
    "pt_ps_sparse_pull": ([ctypes.c_int64, ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_float)],
                          ctypes.c_int),
    "pt_ps_sparse_push": ([ctypes.c_int64, ctypes.c_char_p,
                           ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_float)],
                          ctypes.c_int),
    "pt_ps_sparse_size": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int64),
    "pt_ps_save": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int),
    "pt_ps_load": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int),
    "pt_ps_heartbeat": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int64),
    "pt_ps_liveness": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int64),
    # the tokenizer's handles are int64: ctypes' default int restype
    # would truncate them
    "pt_tok_build": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_int],
                     ctypes.c_int64),
    "pt_tok_destroy": ([ctypes.c_int64], None),
    "pt_tok_vocab_size": ([ctypes.c_int64], ctypes.c_int64),
    "pt_tok_lookup": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int64),
    "pt_tok_word": ([ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                     ctypes.c_int64], ctypes.c_int64),
    "pt_tok_freqs": ([ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                      ctypes.c_int64], ctypes.c_int64),
    "pt_tok_encode": ([ctypes.c_int64, ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                       ctypes.c_int64], ctypes.c_int64),
    "pt_tok_encode_file": ([ctypes.c_int64, ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                            ctypes.c_int64], ctypes.c_int64),
    "pt_tok_save": ([ctypes.c_int64, ctypes.c_char_p], ctypes.c_int),
    "pt_tok_load": ([ctypes.c_char_p], ctypes.c_int64),
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


def available() -> bool:
    """Whether the library builds and loads (building it if needed)."""
    try:
        _load()
        return True
    # ptlint: disable=silent-failure -- the answer to "can it load" is False when the build or load raises; callers that need the error call build()
    except Exception:  # noqa: BLE001
        return False


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


class SlotSpec:
    """One input slot: dense (a fixed-width float vector, ``dim`` wide) or
    sparse (an int64 id list, padded or cut to ``dim``)."""

    def __init__(self, name: str, kind: str, dim: int) -> None:
        if kind not in ("dense", "sparse"):
            raise ValueError(f"slot kind must be dense|sparse, got {kind}")
        self.name, self.kind, self.dim = name, kind, dim

    @property
    def dense(self) -> bool:
        return self.kind == "dense"

    def descr(self) -> str:
        return f"{self.name}:{self.kind}:{self.dim}"


def _ptrs(arrays: List[np.ndarray]):
    out = (ctypes.c_void_p * max(len(arrays), 1))()
    for i, a in enumerate(arrays):
        out[i] = a.ctypes.data_as(ctypes.c_void_p)
    return out


class NativeDataFeed:
    """The threaded file -> record -> batch pipeline of
    ``csrc/data_feed.cc`` (one line per record, each slot ``<count>
    v...`` in declaration order). ``start()`` streams the files through
    ``num_threads`` readers; ``load_into_memory()`` parses them once,
    ``local_shuffle(seed)`` permutes the records (``std::mt19937_64``, so
    the same seed gives the same order as the JAX package's feed over the
    same records) and ``start_from_memory()`` batches them in order.
    Iterating yields numpy batches: a dense slot float32 ``[rows, dim]``,
    a sparse one int64 ``[rows, dim]`` zero-padded plus ``<name>_len``
    int64 ``[rows]``."""

    def __init__(self, slots: Sequence[SlotSpec], batch_size: int,
                 num_threads: int = 4, queue_capacity: int = 64) -> None:
        lib = _load()
        self.slots = list(slots)
        self.batch_size = batch_size
        desc = ";".join(s.descr() for s in self.slots)
        self._h = lib.pt_df_create(desc.encode(), batch_size, num_threads,
                                   queue_capacity)
        if self._h < 0:
            raise RuntimeError(f"bad slot spec: {desc}")
        self._dense = [s for s in self.slots if s.dense]
        self._sparse = [s for s in self.slots if not s.dense]

    def set_files(self, files: Sequence[str]) -> None:
        _load().pt_df_set_files(self._h, ";".join(files).encode())

    def start(self) -> None:
        if _load().pt_df_start(self._h) != 0:
            raise RuntimeError("data feed start failed")

    def load_into_memory(self) -> int:
        n = _load().pt_df_load_into_memory(self._h)
        if n < 0:
            raise RuntimeError("load_into_memory failed (unreadable file?)")
        return n

    def local_shuffle(self, seed: int = 0) -> None:
        _load().pt_df_local_shuffle(self._h, seed)

    def start_from_memory(self) -> None:
        if _load().pt_df_start_from_memory(self._h) != 0:
            raise RuntimeError("start_from_memory failed")

    def memory_size(self) -> int:
        return _load().pt_df_memory_size(self._h)

    def clear_memory(self) -> None:
        _load().pt_df_clear_memory(self._h)

    def serialize_range(self, begin: int, end: int) -> bytes:
        """Records ``[begin, end)`` of memory as one blob (the global
        shuffle's exchange format)."""
        lib = _load()
        need = lib.pt_df_serialize_range(self._h, begin, end, None, 0)
        if need < 0:
            raise ValueError(f"bad range [{begin},{end})")
        buf = (ctypes.c_uint8 * max(need, 1))()
        got = lib.pt_df_serialize_range(self._h, begin, end, buf, need)
        if got != need:
            raise RuntimeError("serialize_range failed")
        return bytes(buf[:need])

    def deserialize_append(self, data: bytes) -> int:
        """Appends a ``serialize_range`` blob's records to memory; returns
        how many."""
        n = _load().pt_df_deserialize_append(self._h, _bytes_arg(data),
                                             len(data))
        if n < 0:
            raise RuntimeError("deserialize_append: corrupt payload")
        return n

    def next_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """One batch as numpy arrays; None at the end of the epoch."""
        bs = self.batch_size
        dense = [np.empty((bs, s.dim), np.float32) for s in self._dense]
        sparse = [np.empty((bs, s.dim), np.int64) for s in self._sparse]
        lens = [np.empty((bs,), np.int64) for _ in self._sparse]
        rows = _load().pt_df_next(self._h, _ptrs(dense), _ptrs(sparse),
                                  _ptrs(lens))
        if rows < 0:
            raise RuntimeError("data feed error")
        if rows == 0:
            return None
        out: Dict[str, np.ndarray] = {}
        for s, a in zip(self._dense, dense):
            out[s.name] = a[:rows]
        for s, a, n in zip(self._sparse, sparse, lens):
            out[s.name] = a[:rows]
            out[s.name + "_len"] = n[:rows]
        return out

    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def close(self) -> None:
        if getattr(self, "_h", -1) > 0:
            _load().pt_df_destroy(self._h)
            self._h = -1

    def __del__(self):
        if getattr(self, "_h", -1) > 0 and _lib is not None:
            _lib.pt_df_destroy(self._h)
            self._h = -1


# ---------------------------------------------------------------------------
# the control plane
# ---------------------------------------------------------------------------

class ControlPlaneServer:
    """Key/value and barrier server (``csrc/control_plane.cc``); one per
    job, on an ephemeral port unless ``port`` is given."""

    def __init__(self, port: int = 0) -> None:
        lib = _load()
        self._h = lib.pt_cp_server_start(port)
        if self._h < 0:
            raise RuntimeError(f"control-plane server failed on port {port}")
        self.port = lib.pt_cp_server_port(self._h)

    def stop(self) -> None:
        if getattr(self, "_h", -1) > 0:
            _load().pt_cp_server_stop(self._h)
            self._h = -1

    def __enter__(self) -> "ControlPlaneServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __del__(self) -> None:
        if getattr(self, "_h", -1) > 0 and _lib is not None:
            _lib.pt_cp_server_stop(self._h)


class ControlPlaneClient:
    """A client of the control plane; safe from several threads. ``set``
    and ``get`` move bytes under a key (``get`` may block until the key
    appears), ``add`` is an atomic counter, ``barrier`` waits for
    ``world`` arrivals under a name."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout_ms: int = 30000) -> None:
        lib = _load()
        self._h = lib.pt_cp_client_connect(host.encode(), port, timeout_ms)
        if self._h < 0:
            raise RuntimeError(
                f"connect to control plane {host}:{port} failed")

    def set(self, key: str, value: bytes) -> None:
        buf = (ctypes.c_uint8 * len(value)).from_buffer_copy(value)
        rc = _load().pt_cp_set(self._h, key.encode(), buf, len(value))
        if rc != 0:
            raise RuntimeError(f"control-plane set({key!r}) failed")

    def get(self, key: str, block: bool = True, timeout_ms: int = 30000,
            max_size: int = 1 << 20) -> bytes:
        buf = (ctypes.c_uint8 * max_size)()
        n = _load().pt_cp_get(self._h, key.encode(), buf, max_size,
                              1 if block else 0, timeout_ms)
        if n == -3:  # the buffer is too small: grow and ask again
            return self.get(key, block, timeout_ms, max_size * 16)
        if n == -2:
            raise TimeoutError(
                f"control-plane get({key!r}) timed out after {timeout_ms}ms")
        if n == -1:
            raise KeyError(key)
        if n < 0:
            raise RuntimeError(f"control-plane get({key!r}) transport error")
        return bytes(buf[:n])

    def add(self, key: str, delta: int = 1) -> int:
        v = _load().pt_cp_add(self._h, key.encode(), delta)
        if v == -(2 ** 63):
            raise RuntimeError(f"control-plane add({key!r}) failed")
        return v

    def barrier(self, name: str, world: int,
                timeout_ms: int = 60000) -> None:
        rc = _load().pt_cp_barrier(self._h, name.encode(), world,
                                   timeout_ms)
        if rc != 0:
            raise TimeoutError(f"barrier {name!r} timed out "
                               f"(world={world})")

    def close(self) -> None:
        if getattr(self, "_h", -1) > 0:
            _load().pt_cp_client_close(self._h)
            self._h = -1

    def __enter__(self) -> "ControlPlaneClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the parameter server
# ---------------------------------------------------------------------------

_OPT_CODES = {"sgd": 0, "adagrad": 1, "adam": 2, "sum": 3}


def _hyper_array(lr: float, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
    return (ctypes.c_float * 4)(lr, beta1, beta2, eps)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class PsServer:
    """One parameter-server shard (``csrc/ps_service.cc``): dense and
    sparse tables whose optimizer (sgd, adagrad, adam, or ``sum`` for a
    delta table) runs on the server at each push, on an ephemeral port
    unless ``port`` is given; its threads serve until :meth:`stop`."""

    def __init__(self, port: int = 0) -> None:
        lib = _load()
        self._h = lib.pt_ps_server_start(port)
        if self._h < 0:
            raise RuntimeError(f"ps server failed on port {port}")
        self.port = lib.pt_ps_server_port(self._h)

    def stop(self) -> None:
        if getattr(self, "_h", -1) > 0:
            _load().pt_ps_server_stop(self._h)
            self._h = -1

    def __enter__(self) -> "PsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __del__(self) -> None:
        if getattr(self, "_h", -1) > 0 and _lib is not None:
            _lib.pt_ps_server_stop(self._h)
            self._h = -1


class PsClient:
    """A connection to one shard. Dense tables: ``dense_init`` (a sync
    table, ``sync_world`` > 0, applies the mean of that many pushes at
    once and bumps its version), ``dense_push`` (the version after it),
    ``dense_pull`` (waits for ``min_version``). Sparse tables: rows made
    on first pull (uniform in ``+-init_scale``, the same for an id on any
    server), ``sparse_push`` applies the optimizer per row. ``heartbeat``
    / ``liveness_ms`` for a worker's liveness, ``save``/``load`` of the
    shard's tables with their optimizer state."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout_ms: int = 30000) -> None:
        self._h = _load().pt_ps_connect(host.encode(), port, timeout_ms)
        if self._h < 0:
            raise RuntimeError(f"connect to ps {host}:{port} failed")

    def close(self) -> None:
        if getattr(self, "_h", -1) > 0:
            _load().pt_ps_disconnect(self._h)
            self._h = -1

    def __enter__(self) -> "PsClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def dense_init(self, name: str, values: Optional[np.ndarray], n: int,
                   optimizer: str = "sgd", lr: float = 0.01,
                   beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-8, sync_world: int = 0) -> None:
        ptr = None
        if values is not None:
            values = np.ascontiguousarray(values, np.float32).reshape(-1)
            if values.size != n:
                raise ValueError(f"ps dense_init({name!r}): {values.size} "
                                 f"values for a table of {n}")
            ptr = _fptr(values)
        rc = _load().pt_ps_dense_init(
            self._h, name.encode(), n, ptr, _OPT_CODES[optimizer],
            _hyper_array(lr, beta1, beta2, eps), sync_world)
        if rc != 0:
            raise RuntimeError(f"ps dense_init({name!r}) failed ({rc})")

    def dense_pull(self, name: str, n: int, min_version: int = 0,
                   timeout_ms: int = 60000) -> Tuple[np.ndarray, int]:
        out = np.empty(n, np.float32)
        ver = _load().pt_ps_dense_pull(self._h, name.encode(), _fptr(out), n,
                                       min_version, timeout_ms)
        if ver < 0:
            raise TimeoutError(
                f"ps dense_pull({name!r}, min_version={min_version}) "
                f"failed ({ver})")
        return out, int(ver)

    def dense_push(self, name: str, grad: np.ndarray) -> int:
        grad = np.ascontiguousarray(grad, np.float32).reshape(-1)
        ver = _load().pt_ps_dense_push(self._h, name.encode(), _fptr(grad),
                                       grad.size)
        if ver < 0:
            raise RuntimeError(f"ps dense_push({name!r}) failed ({ver})")
        return int(ver)

    def sparse_init(self, name: str, dim: int, optimizer: str = "sgd",
                    lr: float = 0.01, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    init_scale: float = 0.0) -> None:
        rc = _load().pt_ps_sparse_init(
            self._h, name.encode(), dim, _OPT_CODES[optimizer],
            _hyper_array(lr, beta1, beta2, eps), init_scale)
        if rc != 0:
            raise RuntimeError(f"ps sparse_init({name!r}) failed ({rc})")

    def sparse_pull(self, name: str, ids: np.ndarray,
                    dim: int) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        out = np.empty((ids.size, dim), np.float32)
        rc = _load().pt_ps_sparse_pull(self._h, name.encode(), _iptr(ids),
                                       ids.size, dim, _fptr(out))
        if rc != 0:
            raise RuntimeError(f"ps sparse_pull({name!r}) failed ({rc})")
        return out

    def sparse_push(self, name: str, ids: np.ndarray, grads: np.ndarray,
                    dim: int) -> None:
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        grads = np.ascontiguousarray(grads, np.float32).reshape(-1)
        if grads.size != ids.size * dim:
            raise ValueError(f"ps sparse_push({name!r}): {grads.size} "
                             f"values for {ids.size} rows of {dim}")
        rc = _load().pt_ps_sparse_push(self._h, name.encode(), _iptr(ids),
                                       ids.size, dim, _fptr(grads))
        if rc != 0:
            raise RuntimeError(f"ps sparse_push({name!r}) failed ({rc})")

    def sparse_size(self, name: str) -> int:
        v = _load().pt_ps_sparse_size(self._h, name.encode())
        if v < 0:
            raise RuntimeError(f"ps sparse_size({name!r}) failed ({v})")
        return int(v)

    def heartbeat(self, worker: str) -> None:
        """Records a liveness beat for ``worker`` on the server."""
        v = _load().pt_ps_heartbeat(self._h, worker.encode())
        if v < 0:
            raise RuntimeError(f"ps heartbeat({worker!r}) failed ({v})")

    def liveness_ms(self, worker: str) -> Optional[int]:
        """Milliseconds since ``worker``'s last beat, None if it never
        beat."""
        v = _load().pt_ps_liveness(self._h, worker.encode())
        if v == -1:
            return None
        if v < 0:
            raise RuntimeError(f"ps liveness({worker!r}) failed ({v})")
        return int(v)

    def save(self, path: str) -> None:
        if _load().pt_ps_save(self._h, path.encode()) != 0:
            raise RuntimeError(f"ps save({path!r}) failed")

    def load(self, path: str) -> None:
        if _load().pt_ps_load(self._h, path.encode()) != 0:
            raise RuntimeError(f"ps load({path!r}) failed")


# -------------------------------------------------------------- tokenizer

class Tokenizer:
    """Native corpus tokenizer/vocab (``csrc/tokenizer.cc``): threaded
    frequency counting over files, whitespace encoding to ids, off the
    GIL. The JAX package's class, over this package's copy of the
    library."""

    def __init__(self, handle: int):
        if handle < 0:
            raise RuntimeError("tokenizer build/load failed")
        self._h = handle

    @classmethod
    def build(cls, files: Sequence[str], min_freq: int = 1,
              num_threads: int = 4) -> "Tokenizer":
        return cls(_load().pt_tok_build(";".join(files).encode(), min_freq,
                                        num_threads))

    @classmethod
    def load(cls, path: str) -> "Tokenizer":
        return cls(_load().pt_tok_load(path.encode()))

    def save(self, path: str) -> None:
        if _load().pt_tok_save(self._h, path.encode()) != 0:
            raise RuntimeError(f"tokenizer save to {path} failed")

    def __len__(self) -> int:
        v = _load().pt_tok_vocab_size(self._h)
        if v < 0:
            raise RuntimeError("tokenizer closed")
        return int(v)

    def lookup(self, word: str) -> Optional[int]:
        v = _load().pt_tok_lookup(self._h, word.encode())
        if v == -2:
            raise RuntimeError("tokenizer closed")
        return None if v == -1 else int(v)

    def word(self, idx: int) -> str:
        cap = 4096
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = _load().pt_tok_word(self._h, idx, buf, cap)
            if n == -2:  # the buffer is too small, NOT a bad index
                cap *= 8
                continue
            if n == -3:
                raise RuntimeError("tokenizer closed")
            if n < 0:
                raise IndexError(idx)
            return buf.value.decode()

    def freqs(self) -> np.ndarray:
        """Per-id corpus counts from ``build`` (empty for a loaded
        vocabulary)."""
        n = len(self)
        out = np.zeros(n, np.int64)
        v = _load().pt_tok_freqs(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
        if v == -3:
            raise RuntimeError("tokenizer closed")
        return out[:max(0, int(v))]

    def _encode_with(self, fn, arg: bytes, unk_id: int) -> np.ndarray:
        # the library returns the count it needs when the buffer is short:
        # grow to it and encode again
        cap = 1 << 16
        while True:
            out = np.empty(cap, np.int64)
            n = fn(self._h, arg,
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
                   unk_id)
            if n < 0:
                raise RuntimeError("tokenizer encode failed")
            if n <= cap:
                return out[:n].copy()
            cap = int(n)

    def encode(self, text: str, unk_id: int = -1) -> np.ndarray:
        return self._encode_with(_load().pt_tok_encode, text.encode(),
                                 unk_id)

    def encode_file(self, path: str, unk_id: int = -1) -> np.ndarray:
        return self._encode_with(_load().pt_tok_encode_file, path.encode(),
                                 unk_id)

    def close(self) -> None:
        if self._h > 0:
            _load().pt_tok_destroy(self._h)
            self._h = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
