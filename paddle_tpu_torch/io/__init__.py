"""Checkpoints: checkpoint v3, the JAX package's on-disk format.

Counterpart of ``paddle_tpu.io``. A checkpoint is a directory::

  checkpoint/
    manifest.json   sentinel ``__paddle_tpu_ckpt__`` (version 3), step,
                    tree structure, per-leaf shape/dtype/crc32/nbytes,
                    and ``host_state``
    data/<leaf path with / -> __>.npy   one npy per leaf
    COMMIT          written last; carries the manifest's CRC32

staged in ``<path>.tmp`` and moved into place with ``os.replace``. A
leaf's path is its dict keys (list indices) joined by ``/``, dict keys
in sorted order, as the JAX package flattens a pytree; so the two
packages read each other's checkpoints. Versions 1-3 load.

Leaves are tensors (or numpy arrays, or Python scalars). A bf16 leaf
(numpy has no bfloat16) is written as its uint16 bits with manifest
dtype ``"bfloat16"`` and read back as a bf16 tensor; other floats numpy
lacks (float8) the same way. A JAX PRNG key leaf (manifest dtype
``"prng_key:<impl>"``) loads as its raw uint32 bits. Loaded leaves are
CPU tensors in the dtype the checkpoint stored.

Integrity: a directory without ``COMMIT`` is an unfinished save and is
never restored; :func:`load` checks each leaf's size, and with
``verify_integrity`` (default: the ``checkpoint_verify`` flag) the
``COMMIT`` marker and each leaf's CRC32, before deserialising;
:func:`verify` reports every problem without building a tensor;
``AsyncCheckpointer.restore_latest`` falls back to the newest intact
checkpoint.

``AsyncCheckpointer.save`` blocks the host only to enqueue one copy of
each device leaf into pinned host memory on the current stream (memory
pinned at the first save and reused by the next), and records an event
after them; a writer thread waits on that event, then serialises,
checksums and writes. The copies are stream-ordered before
any later work on that stream, so a train step that runs at once and
rewrites the same tensors in place cannot tear the save. A writer's
failure is re-raised at the next ``save()`` or ``wait()``.

Telemetry, as the JAX package's: ``checkpoint_corrupt_total`` and a
``checkpoint_corrupt`` flight event per checkpoint a restore skipped,
``checkpoint_failures_total`` and ``checkpoint_write_failed`` per failed
background save, and the ``ckpt_write`` fault point before each leaf
written (``testing.faults``).

The host-blocking parts of ``AsyncCheckpointer.save`` and ``wait`` are
charged to the goodput ledger's ``checkpoint`` bucket
(``observability.goodput``; the writer thread overlaps training and is
not charged).

``save_inference_model`` exports a layer through ``jit.save`` (a
non-layer model saves its ``params`` alone, with an ``inference.json``
marker, as the JAX package does); ``load_inference_model(dir, model=)``
fills a port model from either package's artifact, both of which keep
their weights in ``params/`` in checkpoint v3 under the same dotted
names.

Not ported: the ``*_persistables``/``*_params`` Executor shims (the
static ``Program``/``Executor``).
"""

from __future__ import annotations

import io as _pyio
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..flags import GLOBAL_FLAGS
from ..observability import flight as _flight
from ..observability import goodput as _goodput
from ..observability import metrics as _metrics
from ..testing import faults as _faults

__all__ = ["save", "load", "is_committed", "load_step", "load_host_state",
           "verify", "flatten", "AsyncCheckpointer", "save_dygraph",
           "load_dygraph", "save_inference_model", "load_inference_model"]

_SENTINEL_KEY = "__paddle_tpu_ckpt__"
_VERSION = 3                    # v3 adds host_state + PRNG-key leaves
_SUPPORTED_VERSIONS = (1, 2, 3)  # v1 (pre-integrity) / v2 stay loadable
_COMMIT_NAME = "COMMIT"
_KEY_DTYPE_PREFIX = "prng_key:"  # manifest dtype marker for key arrays

_BUILTIN_DTYPES = {
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
    "uint32", "uint64", "float16", "float32", "float64", "complex64",
    "complex128"}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) and x is not None


def _items(tree):
    """(key, child) pairs in the JAX flatten order: dict keys sorted,
    sequences by index."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def flatten(tree) -> Dict[str, Any]:
    """``{leaf path: leaf}`` in the JAX package's order and spelling
    (``"opt/slots/<name>/m"``). ``None`` and empty containers hold no
    leaf; a flat dict of paths flattens to itself."""
    out: Dict[str, Any] = {}

    def walk(node, prefix: str) -> None:
        if node is None:
            return
        if _is_leaf(node):
            out[prefix] = node
            return
        for k, child in _items(node):
            walk(child, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return out


def _treedef(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` spells a
    tree of dicts, lists and tuples."""

    def fmt(node) -> str:
        if node is None:
            return "None"
        if _is_leaf(node):
            return "*"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(node[k])}"
                                   for k in sorted(node)) + "}"
        inner = ", ".join(fmt(v) for v in node)
        if isinstance(node, tuple):
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "[" + inner + "]"

    return f"PyTreeDef({fmt(tree)})"


def _unflatten_like(target, flat: Dict[str, Any]):
    """``target``'s structure with each leaf whose path is in ``flat``
    replaced by that value (moved to the leaf's device when the leaf is
    a tensor); other leaves kept."""

    def walk(node, prefix: str):
        if node is None:
            return None
        if _is_leaf(node):
            if prefix not in flat:
                return node
            value = flat[prefix]
            if isinstance(node, torch.Tensor):
                value = value.to(node.device)
            return value
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        vals = [walk(v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(node)]
        if hasattr(node, "_fields"):  # a namedtuple
            return type(node)(*vals)
        return type(node)(vals)

    return walk(target, "")


# ---------------------------------------------------------------------------
# leaves between tensors and npy files
# ---------------------------------------------------------------------------

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


# a dtype's bits as a signed integer tensor of its size
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}


def _host_copies(flat: Dict[str, Any], non_blocking: bool,
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
    """``(host leaves, events)``: a host copy of every tensor leaf (of a
    device tensor: pinned and enqueued on the current stream with
    ``non_blocking``, and an event recorded after the copies of each
    device; of a CPU tensor: a clone, as the caller may update it in
    place); numpy and scalar leaves as ``np.asarray``. ``buffers`` (leaf
    path -> pinned tensor) are reused where shape and dtype match, and
    take the new ones."""
    out: Dict[str, Any] = {}
    devices = set()
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.is_cuda:
                h = None if buffers is None else buffers.get(k)
                if h is None or h.shape != v.shape or h.dtype != v.dtype:
                    h = torch.empty(v.shape, dtype=v.dtype,
                                    pin_memory=non_blocking)
                    if buffers is not None:
                        buffers[k] = h
                h.copy_(v, non_blocking=non_blocking)
                devices.add(v.device)
                out[k] = h
            else:
                out[k] = v.clone()
        else:
            out[k] = np.asarray(v)
    events = []
    for dev in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return out, events


def _as_array(v) -> Tuple[np.ndarray, str]:
    """A host leaf as (the array written, the manifest dtype)."""
    if isinstance(v, torch.Tensor):
        name = _dtype_name(v.dtype)
        if name in _BUILTIN_DTYPES:
            return v.contiguous().numpy(), name
        # bfloat16, float8_*: the bits as an unsigned integer
        n = v.element_size()
        bits = v.contiguous().view(_INT_OF_SIZE[n]).numpy()
        return bits.view(np.dtype(f"u{n}")), name
    arr = np.asarray(v)
    name = str(arr.dtype)
    # numpy serialises ml_dtypes floats (bfloat16, float8_*) as raw void
    # records: store their bits and restore via the manifest's dtype
    if arr.dtype.kind in "Vf" and name not in _BUILTIN_DTYPES:
        arr = arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
    return arr, name


def _as_tensor(arr: np.ndarray, want: Optional[str]) -> torch.Tensor:
    """A loaded npy array as a CPU tensor of the manifest's dtype."""
    if want and want.startswith(_KEY_DTYPE_PREFIX):
        return torch.from_numpy(np.ascontiguousarray(arr, np.uint32))
    if want and str(arr.dtype) != want:
        if want not in _BUILTIN_DTYPES:
            bits = arr.view(np.dtype(f"i{arr.dtype.itemsize}"))
            return torch.from_numpy(bits).view(getattr(torch, want))
        if arr.dtype.kind == "V":  # legacy bf16-as-void files
            bits = torch.from_numpy(arr.view(np.int16))
            return bits.view(torch.bfloat16).to(getattr(torch, want))
    return torch.from_numpy(arr)


def _leaf_file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _write_npy(fpath: str, arr: np.ndarray) -> Tuple[int, int]:
    """Writes ``arr`` as an npy file (``np.save``'s bytes for a C-ordered
    array), returning (CRC32, size) of exactly the bytes written (no
    read-back pass). The data goes from the array's own memory to the
    file and the CRC: no copy in between, and neither holds the GIL, so a
    writer thread leaves the training loop's host calls alone."""
    fmt = np.lib.format
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    head = _pyio.BytesIO()
    fmt.write_array_header_1_0(head, fmt.header_data_from_array_1_0(arr))
    head = head.getvalue()
    data = memoryview(arr.reshape(-1).view(np.uint8))
    with open(fpath, "wb") as f:
        f.write(head)
        f.write(data)
    return zlib.crc32(data, zlib.crc32(head)), len(head) + data.nbytes


def _note_corrupt(path: str, error: Any,
                  step: Optional[int] = None) -> None:
    """Count + flight-record a checkpoint skipped as corrupt or
    uncommitted."""
    _metrics.counter(
        "checkpoint_corrupt_total",
        "checkpoints skipped at restore time because they were "
        "corrupt or uncommitted (restore fell back to the newest "
        "intact one)", always=True).inc()
    _flight.record("checkpoint_corrupt", force=True, path=str(path),
                   step=step, error=str(error)[:300])


def _note_save_failure(step: Optional[int], error: BaseException) -> None:
    _metrics.counter(
        "checkpoint_failures_total",
        "checkpoint saves that raised (background writer failures "
        "are re-raised at the next save()/wait())",
        always=True).inc()
    _flight.record("checkpoint_write_failed", force=True, step=step,
                   error=str(error)[:300])


def _write(host: Dict[str, Any], treedef: str, path: str,
           step: Optional[int], overwrite: bool,
           host_state: Optional[Dict[str, Any]]) -> None:
    """Writes host leaves as a checkpoint at ``path`` (staged in
    ``<path>.tmp``, COMMIT last, then moved into place)."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "data"), exist_ok=True)
    leaves: Dict[str, Dict[str, Any]] = {}
    for k, v in host.items():
        arr, dtype_str = _as_array(v)
        _faults.hit("ckpt_write", step=step)
        crc, nbytes = _write_npy(os.path.join(tmp, "data", _leaf_file(k)),
                                 arr)
        leaves[k] = {"shape": list(arr.shape), "dtype": dtype_str,
                     "crc32": crc, "nbytes": nbytes}
    manifest = {_SENTINEL_KEY: _VERSION, "step": step,
                "treedef": treedef, "leaves": leaves}
    if host_state is not None:
        manifest["host_state"] = host_state
    mbytes = json.dumps(manifest, indent=1).encode()
    with open(os.path.join(tmp, "manifest.json"), "wb") as f:
        f.write(mbytes)
    # COMMIT last: a directory without it is an unfinished save, also on
    # a filesystem without atomic rename
    with open(os.path.join(tmp, _COMMIT_NAME), "w") as f:
        json.dump({"manifest_crc32": zlib.crc32(mbytes), "step": step,
                   "n_leaves": len(leaves)}, f)
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def save(state: Any, path: str, step: Optional[int] = None,
         overwrite: bool = True,
         host_state: Optional[Dict[str, Any]] = None) -> None:
    """Saves a tree of tensors (a state dict, ``TrainStep.state_dict()``)
    to ``path``, synchronously. ``host_state`` is a JSON-serialisable
    dict of the host's training position (global step, epoch, batch in
    epoch), kept in the manifest beside the leaves."""
    # a trailing separator would stage the tmp dir INSIDE the target,
    # which the overwrite rmtree then destroys mid-save
    path = os.path.normpath(path)
    host, _ = _host_copies(flatten(state), non_blocking=False)
    _write(host, _treedef(state), path, step, overwrite, host_state)


def _read_manifest(path: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"checkpoint {path!r}: manifest.json is corrupt ({e}) — run "
            f"paddle_tpu_torch.io.verify({path!r}) for a full report")
    if manifest.get(_SENTINEL_KEY) not in _SUPPORTED_VERSIONS:
        raise ValueError(f"{path} is not a paddle_tpu checkpoint")
    return manifest


def is_committed(path: str) -> bool:
    """Cheap intact check: the manifest parses and, for v2+, the COMMIT
    marker exists. No data file is touched."""
    path = os.path.normpath(path)
    try:
        manifest = _read_manifest(path)
    except (OSError, ValueError):
        return False
    if manifest.get(_SENTINEL_KEY, 0) >= 2:
        return os.path.exists(os.path.join(path, _COMMIT_NAME))
    return True


def load(path: str, target: Optional[Any] = None,
         verify_integrity: Optional[bool] = None) -> Any:
    """Loads a checkpoint: a flat ``{leaf path: CPU tensor}`` dict, or
    with ``target`` (a tree) that tree with each leaf the checkpoint
    holds replaced by it (on the target leaf's device, in the stored
    dtype) and the others kept.

    ``verify_integrity`` (default: the ``checkpoint_verify`` flag)
    checks the COMMIT marker and each leaf's CRC32 before
    deserialising; a missing or size-mismatched leaf file always raises
    a ValueError naming the checkpoint and the leaf."""
    path = os.path.normpath(path)
    if verify_integrity is None:
        verify_integrity = bool(GLOBAL_FLAGS.get("checkpoint_verify"))
    manifest = _read_manifest(path)
    version = manifest.get(_SENTINEL_KEY, 0)
    if verify_integrity and version >= 2 \
            and not os.path.exists(os.path.join(path, _COMMIT_NAME)):
        raise ValueError(
            f"checkpoint {path!r}: missing its COMMIT marker — the save "
            "never completed; restore from an older checkpoint (run "
            f"paddle_tpu_torch.io.verify({path!r}) for a full report)")
    flat = {}
    for k, meta in manifest["leaves"].items():
        fname = _leaf_file(k)
        fpath = os.path.join(path, "data", fname)
        meta_d = meta if isinstance(meta, dict) else {}
        if not os.path.exists(fpath):
            raise ValueError(
                f"checkpoint {path!r}: leaf {k!r} is missing its data "
                f"file ({fname}) — run paddle_tpu_torch.io.verify("
                f"{path!r}) for a full report")
        nbytes = meta_d.get("nbytes")
        if nbytes is not None and os.path.getsize(fpath) != nbytes:
            raise ValueError(
                f"checkpoint {path!r}: leaf {k!r} is "
                f"{os.path.getsize(fpath)} bytes on disk but the manifest "
                f"records {nbytes} — truncated or corrupt; run "
                f"paddle_tpu_torch.io.verify({path!r}) for a full report")
        with open(fpath, "rb") as f:
            raw = f.read()
        crc = meta_d.get("crc32")
        if verify_integrity and crc is not None \
                and zlib.crc32(raw) != crc:
            raise ValueError(
                f"checkpoint {path!r}: leaf {k!r} fails its CRC32 check "
                "— corrupt data file; run paddle_tpu_torch.io.verify("
                f"{path!r}) for a full report")
        flat[k] = _as_tensor(np.load(_pyio.BytesIO(raw)),
                             meta_d.get("dtype"))
    if target is None:
        return flat
    return _unflatten_like(target, flat)


def load_step(path: str) -> Optional[int]:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("step")


def load_host_state(path: str) -> Optional[Dict[str, Any]]:
    """The manifest's ``host_state`` (v3), or None (pre-v3, or saved
    without one). Reads only the manifest."""
    with open(os.path.join(os.path.normpath(path), "manifest.json")) as f:
        return json.load(f).get("host_state")


def verify(path: str) -> List[str]:
    """Problems of a checkpoint directory, without deserialising a leaf:
    the manifest parses and carries the sentinel; v2+ has COMMIT and the
    manifest matches the CRC recorded there; every leaf file exists with
    the recorded size and CRC32. ``[]`` means intact."""
    path = os.path.normpath(path)
    problems: List[str] = []
    try:
        manifest = _read_manifest(path)
    except FileNotFoundError:
        return [f"{path}: manifest.json missing"]
    except OSError as e:
        return [f"{path}: manifest.json unreadable ({e})"]
    except ValueError as e:
        return [str(e)]
    if manifest.get(_SENTINEL_KEY, 0) >= 2:
        commit_path = os.path.join(path, _COMMIT_NAME)
        if not os.path.exists(commit_path):
            problems.append(
                f"{path}: COMMIT marker missing (unfinished save)")
        else:
            try:
                with open(commit_path) as f:
                    commit = json.load(f)
                with open(os.path.join(path, "manifest.json"), "rb") as f:
                    mcrc = zlib.crc32(f.read())
                want = commit.get("manifest_crc32")
                if want is not None and want != mcrc:
                    problems.append(
                        f"{path}: manifest.json does not match the CRC "
                        "recorded in COMMIT")
            except (OSError, json.JSONDecodeError) as e:
                problems.append(f"{path}: COMMIT unreadable ({e})")
    for k, meta in manifest.get("leaves", {}).items():
        fname = _leaf_file(k)
        fpath = os.path.join(path, "data", fname)
        meta_d = meta if isinstance(meta, dict) else {}
        if not os.path.exists(fpath):
            problems.append(f"leaf {k!r}: data file missing ({fname})")
            continue
        nbytes = meta_d.get("nbytes")
        if nbytes is not None and os.path.getsize(fpath) != nbytes:
            problems.append(
                f"leaf {k!r}: {os.path.getsize(fpath)} bytes on disk, "
                f"manifest records {nbytes}")
            continue
        crc = meta_d.get("crc32")
        if crc is not None:
            with open(fpath, "rb") as f:
                if zlib.crc32(f.read()) != crc:
                    problems.append(f"leaf {k!r}: CRC32 mismatch")
    return problems


def _ckpt_measure():
    """Goodput-ledger context for the HOST-BLOCKING parts of a save (the
    writer thread overlaps training and is not charged): a no-op context
    unless the ledger runs and metrics are on."""
    return _goodput.ledger().measure("checkpoint")


class AsyncCheckpointer:
    """Saves ``ckpt-<step>`` directories under ``directory`` in a writer
    thread (see the module note), keeping the newest ``max_to_keep``.
    ``last_write_s`` is the last writer's time, from its start (waiting
    for the copies included) to its end."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = directory
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_write_s: Optional[float] = None
        # the pinned host copies of the device leaves, by leaf path: made
        # at the first save, reused by the next ones (page-locking fresh
        # memory is most of a first save's host time)
        self._pinned: Dict[str, torch.Tensor] = {}
        os.makedirs(directory, exist_ok=True)

    def _raise_pending(self) -> None:
        """Re-raises a background writer's failure (once)."""
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint save failed in {self.directory}: "
                f"{err!r} (re-raised at the next save()/wait())") from err

    def save(self, state: Any, step: int,
             host_state: Optional[Dict[str, Any]] = None) -> None:
        """Waits for the previous save, enqueues the host copies and
        returns; the writer thread writes ``ckpt-<step>``."""
        with _ckpt_measure():
            self.wait()  # the writer is done with the pinned copies
            host, events = _host_copies(flatten(state), non_blocking=True,
                                        buffers=self._pinned)
            treedef = _treedef(state)
            path = os.path.join(self.directory, f"ckpt-{step}")

            def work() -> None:
                t0 = time.perf_counter()
                try:
                    for ev in events:
                        ev.synchronize()
                    _write(host, treedef, path, step, True, host_state)
                    self._gc()
                except BaseException as e:  # noqa: BLE001 — re-raised later
                    self._error = e
                    _note_save_failure(step, e)
                self.last_write_s = time.perf_counter() - t0

            self._thread = threading.Thread(target=work, daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            with _ckpt_measure():
                self._thread.join()
                self._thread = None
        self._raise_pending()

    def _complete_steps(self) -> Dict[int, str]:
        """``{step: dir}`` of the ``ckpt-<digits>`` entries. Other
        ``ckpt-*`` entries are staging leftovers of a crashed save: they
        are reaped, unless this checkpointer's own save is in flight
        (its ``.tmp`` is live)."""
        writing = self._thread is not None and self._thread.is_alive()
        out: Dict[int, str] = {}
        for d in os.listdir(self.directory):
            if not d.startswith("ckpt-"):
                continue
            suffix = d.split("-", 1)[1]
            if suffix.isdigit():
                out[int(suffix)] = d
            elif not writing:
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
        return out

    def _gc(self) -> None:
        steps = self._complete_steps()
        for s in sorted(steps)[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, steps[s]),
                          ignore_errors=True)

    def intact_steps(self) -> List[int]:
        """Steps whose directories pass the cheap commit check,
        ascending."""
        return [s for s in sorted(self._complete_steps())
                if is_committed(os.path.join(self.directory, f"ckpt-{s}"))]

    def latest_step(self) -> Optional[int]:
        steps = self.intact_steps()
        return steps[-1] if steps else None

    def host_state(self, step: Optional[int] = None
                   ) -> Optional[Dict[str, Any]]:
        """The ``host_state`` of one checkpoint (default: the newest
        committed); None when absent or nothing is committed."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return load_host_state(os.path.join(self.directory, f"ckpt-{step}"))

    def verify(self, step: Optional[int] = None) -> List[str]:
        """:func:`verify` of one checkpoint (default: the newest
        committed)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return [f"{self.directory}: no committed checkpoints"]
        return verify(os.path.join(self.directory, f"ckpt-{step}"))

    def restore_latest(self, target: Any = None
                       ) -> Tuple[Optional[Any], Optional[int]]:
        """``(state, step)`` of the newest INTACT checkpoint, skipping
        corrupt and uncommitted ones; ``(None, None)`` when none is."""
        for s in reversed(sorted(self._complete_steps())):
            path = os.path.join(self.directory, f"ckpt-{s}")
            try:
                if not is_committed(path):
                    raise ValueError(f"checkpoint {path!r}: missing COMMIT "
                                     "marker (unfinished save)")
                return load(path, target), s
            except (OSError, ValueError) as e:
                _note_corrupt(path, e, step=s)
                continue
        return None, None

    def restore(self, target: Any = None, step: Optional[int] = None):
        if step is not None:
            return load(os.path.join(self.directory, f"ckpt-{step}"),
                        target)
        state, _ = self.restore_latest(target)
        return state


# reference-parity entry points -------------------------------------------

def save_dygraph(state_dict: Dict[str, Any], path: str) -> None:
    save(state_dict, path + ".pdparams")


def load_dygraph(path: str):
    return load(path + ".pdparams"), None


def save_inference_model(dirname: str, model, example_args,
                         params: Optional[Dict[str, Any]] = None) -> None:
    """Export a serving artifact (ref: io.py save_inference_model:52):
    a layer's eval forward at the example inputs' shapes through
    ``jit.save``; for any other model, ``params`` alone (a checkpoint
    under ``params/``) and an ``inference.json`` marker."""
    from .. import jit as jit_mod
    if isinstance(model, torch.nn.Module):
        spec = [jit_mod.InputSpec(tuple(a.shape), a.dtype)
                for a in (_as_example(a) for a in example_args)]
        jit_mod.save(model, dirname, input_spec=spec)
        return
    save(params or {}, os.path.join(dirname, "params"))
    meta = {"format": "paddle_tpu_inference", "version": _VERSION}
    with open(os.path.join(dirname, "inference.json"), "w") as f:
        json.dump(meta, f)


def _as_example(a):
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.asarray(a))


def load_inference_model(dirname: str, model=None, device=None):
    """A serving artifact of either package, or a params-only one. With
    ``model`` (a port module), its parameters and buffers are filled in
    place from the artifact's ``params/`` (names it lacks are kept) and
    it is returned; without, a port export loads as a
    ``jit.TranslatedLayer`` on ``device`` (None: the card), a JAX export
    is refused by name, and a params-only artifact returns its flat
    ``{name: tensor}``."""
    from .. import jit as jit_mod
    exported = any(os.path.exists(os.path.join(dirname, f))
                   for f in ("module.pt2", "module.bin"))
    if exported and model is None:
        return jit_mod.load(dirname, device)
    flat = load(os.path.join(dirname, "params"))
    if exported:
        # {"params": {...}, "buffers": {...}} flattened to "/"-joined keys
        flat = {k.split("/", 1)[1]: v for k, v in flat.items()
                if k.startswith(("params/", "buffers/"))}
    state = {k.replace("/", "."): v for k, v in flat.items()}
    if model is None:
        return state
    own = model.state_dict()
    with torch.no_grad():
        for k, v in state.items():
            if k in own:
                own[k].copy_(v.to(own[k].dtype))
    return model
