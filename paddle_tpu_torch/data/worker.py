"""Multiprocess DataLoader workers with shared-memory batch transport.

Counterpart of ``paddle_tpu.data.worker``:

- workers parse and collate whole batches; each array or tensor of a
  batch of at least ``_SHM_MIN_BYTES`` (1 MiB, where shared memory
  starts to win on the card's host; the JAX package's 16 KiB) moves to
  the parent through a ``multiprocessing.shared_memory`` segment (one
  copy in the worker, one in the parent, no pickle of the payload),
  smaller ones ride the pickle queue; a batch with arrays of 1 MiB or
  more may stall behind a checkpoint save (see ``_SHM_MIN_BYTES``);
  tensors travel as numpy arrays (bf16 as its int16 bits) and are
  tensors again in the parent;
- a dead worker is found by a liveness check on a queue-get timeout and
  raises a RuntimeError naming it and its exit code; a worker's
  exception is re-raised in the parent with its traceback;
- batches are re-ordered by sequence number, so ``num_workers`` never
  changes the stream; shutdown decodes (and so unlinks) every segment in
  flight, then reaps the workers with bounded joins.

Workers are forked by default, from a parent that may have initialised
CUDA and may have a checkpoint writer thread running. A worker never
touches ``torch.cuda`` (it collates in numpy or CPU tensors), runs
torch single-threaded (an OpenMP pool does not survive a fork), and
shares no lock with the parent's threads: the queues reset their own
after the fork, and nothing else is used. ``timeout`` (seconds, 0 for
none) bounds the wait for one batch, so a wedged worker raises instead
of hanging the consumer.

An error the teardown paths swallow (a payload decoded only to unlink
its segments, a queue already closed) is counted in
``dataloader_swallowed_errors_total{where=}`` with a flight event, as in
the JAX package.
"""

from __future__ import annotations

import itertools
import queue
import time
import traceback
from multiprocessing import get_context, resource_tracker
from multiprocessing.shared_memory import SharedMemory
from typing import Callable, List, Optional

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability import metrics as _metrics

__all__ = ["WorkerInfo", "get_worker_info", "MultiprocessIter",
           "IterableMultiprocessIter"]

# Arrays below this many bytes ride the pickle queue directly; above it
# they move through a shared-memory segment. Measured by
# data/transport_probe.py on the host of an NVIDIA H100 80GB HBM3 at
# 700.00 W (a batch of six arrays, 2 workers, four runs): idle, the queue
# is as fast or faster below 1 MiB (32 KiB: 0.5-0.8 ms a batch against
# 3.2-4.6; 256 KiB: 3.6-5.4 against 5.1-6.6) and shared memory from 1 MiB
# (1 MiB: 11-15 against 14-16). While a writer thread saves a 1.5 GB
# checkpoint, a first touch of memory new to the process stalls for up to
# 0.11-0.26 s, whether the checkpoint goes to the root file system or to
# tmpfs. Shared memory touches fresh pages for every array (a new segment
# each time), so it stalls at every size (90th percentile 70-250 ms a
# batch); the queue reuses the heap's pages, and below 1 MiB, with the
# checkpoint on the root file system, stalls on fewer than one batch in
# ten (90th percentile 1-10 ms; on tmpfs it stalls too). Arrays of 1 MiB
# or more therefore still stall behind a save, by either route: only
# buffers recycled across batches would avoid it.
_SHM_MIN_BYTES = 1 << 20
_SHM = "__shm__"
_TENSOR = "__tensor__"


class WorkerInfo:
    """Per-worker shard info, available inside worker processes via
    :func:`get_worker_info`."""

    def __init__(self, id: int, num_workers: int, seed: int) -> None:
        self.id = id
        self.num_workers = num_workers
        self.seed = seed


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker process: that worker's (id, num_workers, seed).
    In the main process: None."""
    return _worker_info


def _enter_worker(worker_id: int, num_workers: int, seed: int) -> None:
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, seed + worker_id)
    torch.set_num_threads(1)


def _encode_array(arr: np.ndarray, segments: List[SharedMemory]):
    if arr.nbytes < _SHM_MIN_BYTES:
        return arr
    shm = SharedMemory(create=True, size=max(arr.nbytes, 1))
    # ownership passes to the parent (which unlinks after the copy-out):
    # keep this process's resource tracker out of it
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:  # noqa: BLE001 — best effort across versions
        pass
    dst = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)
    np.copyto(dst, arr)
    del dst
    segments.append(shm)
    return (_SHM, shm.name, arr.dtype.str, arr.shape)


def _encode(obj, segments: List[SharedMemory]):
    """Replaces the arrays and CPU tensors of a batch tree with payloads
    a queue carries (shared-memory descriptors for the large ones)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous()
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return (_TENSOR, _encode_array(bits.numpy(), segments),
                str(t.dtype).replace("torch.", ""))
    if isinstance(obj, np.ndarray):
        return _encode_array(obj, segments)
    if isinstance(obj, tuple):
        return tuple(_encode(o, segments) for o in obj)
    if isinstance(obj, list):
        return [_encode(o, segments) for o in obj]
    if isinstance(obj, dict):
        return {k: _encode(v, segments) for k, v in obj.items()}
    return obj


def _decode(obj):
    """Materialises payloads back into arrays and tensors (copy +
    unlink)."""
    if isinstance(obj, tuple):
        if len(obj) == 4 and obj[0] == _SHM:
            _, name, dtype, shape = obj
            shm = SharedMemory(name=name)
            try:
                src = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf)
                out = np.array(src)  # own the data before unlinking
                del src
            finally:
                shm.close()
                shm.unlink()
            return out
        if len(obj) == 3 and obj[0] == _TENSOR:
            t = torch.from_numpy(_decode(obj[1]))
            return t.view(torch.bfloat16) if obj[2] == "bfloat16" else t
        return tuple(_decode(o) for o in obj)
    if isinstance(obj, list):
        return [_decode(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _decode(v) for k, v in obj.items()}
    return obj


def _note_swallowed(where: str, exc: BaseException) -> None:
    """A teardown/decode-path error was deliberately swallowed: count it
    instead of losing it — a failed leftover decode is a leaked shm
    segment, and a string of them should be visible on a dashboard."""
    _metrics.counter(
        "dataloader_swallowed_errors_total",
        "errors swallowed on DataLoader teardown/decode paths "
        "(where: decode_sweep | decode_leftover | shutdown_put | "
        "shutdown_close)", always=True).inc(where=where)
    _flight.record("dataloader_swallowed_error", where=where,
                   error=repr(exc)[:200])


def _decode_quietly(payload, where: str) -> None:
    """Decodes a payload nobody will read, to unlink its segments; a
    failure (a segment the other side already unlinked) is counted in
    ``dataloader_swallowed_errors_total{where=}``, not raised."""
    try:
        _decode(payload)
    except Exception as e:  # noqa: BLE001 — teardown: counted, not raised
        _note_swallowed(where, e)


def _drain_and_reap(result_qs, workers, leftovers,
                    timeout: float = 10.0) -> None:
    """Decodes (and so unlinks) every payload in flight, then reaps the
    workers: runs until they have exited and the queues are empty, so a
    worker that was mid-batch at shutdown strands no segment."""
    if not isinstance(result_qs, (list, tuple)):
        result_qs = [result_qs]

    def sweep(block_s: float) -> bool:
        got = False
        for q in result_qs:
            try:
                item = q.get(timeout=block_s)
            except queue.Empty:
                continue
            got = True
            if item[2] is None:
                _decode_quietly(item[1], "decode_sweep")
        return got

    for payload in leftovers:
        _decode_quietly(payload, "decode_leftover")
    # short polls: at the end of an epoch this runs on the consumer's
    # path, and the workers exit at once
    deadline = time.monotonic() + timeout
    while (any(w.is_alive() for w in workers)
           and time.monotonic() < deadline):
        sweep(0.005)
    for w in workers:
        w.join(timeout=2.0)
        if w.is_alive():
            w.terminate()
            w.join(timeout=1.0)
    while sweep(0.005):  # nothing can be producing any more
        pass


def _map_worker_loop(dataset, collate_fn, index_q, result_q,
                     worker_id: int, num_workers: int, seed: int) -> None:
    _enter_worker(worker_id, num_workers, seed)
    while True:
        item = index_q.get()
        if item is None:
            break
        seq, indices = item
        try:
            batch = collate_fn([dataset[i] for i in indices])
            segments: List[SharedMemory] = []
            payload = _encode(batch, segments)
            result_q.put((seq, payload, None))
            for shm in segments:
                shm.close()
        except Exception:
            result_q.put((seq, None, traceback.format_exc()))


def _iterable_worker_loop(dataset, collate_fn, batch_size: int,
                          drop_last: bool, result_q, worker_id: int,
                          num_workers: int, seed: int,
                          auto_shard: bool, stop_event) -> None:
    """Each worker reads the stream into its OWN bounded queue; with
    ``auto_shard`` worker w sees samples w, w+n, w+2n... The parent
    merges the queues round-robin, so the order is deterministic and the
    backpressure per worker. A dataset that shards itself through
    :func:`get_worker_info` runs with ``auto_shard=False``."""
    _enter_worker(worker_id, num_workers, seed)
    try:
        it = iter(dataset)
        if auto_shard and num_workers > 1:
            it = itertools.islice(it, worker_id, None, num_workers)
        while not stop_event.is_set():
            samples = list(itertools.islice(it, batch_size))
            if not samples or (len(samples) < batch_size and drop_last):
                break
            segments: List[SharedMemory] = []
            payload = _encode(collate_fn(samples), segments)
            posted = False
            while not stop_event.is_set():
                try:
                    result_q.put((None, payload, None), timeout=0.2)
                    posted = True
                    break
                except queue.Full:
                    continue
            for shm in segments:
                shm.close()
                if not posted:  # the parent never saw it: unlink here
                    try:
                        shm.unlink()
                    except FileNotFoundError:
                        pass  # the parent's teardown unlinked it first
            if not posted:
                break
        result_q.put((None, None, "__done__"))
    except Exception:
        result_q.put((None, None, traceback.format_exc()))


def _wait_limit(timeout: float) -> Optional[float]:
    return time.monotonic() + timeout if timeout > 0 else None


def _check_wait(limit: Optional[float], timeout: float, close) -> None:
    if limit is not None and time.monotonic() > limit:
        close()
        raise RuntimeError(f"DataLoader timed out after {timeout} s "
                           "waiting for a batch from its workers")


class MultiprocessIter:
    """Order-preserving multiprocess iterator over a map-style dataset:
    batch index lists go round-robin to ``num_workers`` processes, at
    most ``num_workers * prefetch_factor`` in flight, and results come
    back strictly in sampler order."""

    _GET_TIMEOUT = 5.0

    def __init__(self, dataset, collate_fn: Callable, batch_indices,
                 num_workers: int, prefetch_factor: int = 2,
                 mp_start_method: str = "fork", seed: int = 0,
                 timeout: float = 0.0) -> None:
        ctx = get_context(mp_start_method)
        self._result_q = ctx.Queue()
        self._index_qs = [ctx.Queue() for _ in range(num_workers)]
        self._workers = []
        self._finished = False
        for wid in range(num_workers):
            w = ctx.Process(
                target=_map_worker_loop,
                args=(dataset, collate_fn, self._index_qs[wid],
                      self._result_q, wid, num_workers, seed),
                daemon=True)
            w.start()
            self._workers.append(w)
        self._batches = iter(enumerate(batch_indices))
        self._max_outstanding = max(1, num_workers * prefetch_factor)
        self._outstanding = 0
        self._next_dispatch_worker = 0
        self._next_yield = 0
        self._reorder: dict = {}
        self._timeout = float(timeout)

    def _dispatch_one(self) -> bool:
        try:
            seq, indices = next(self._batches)
        except StopIteration:
            return False
        self._index_qs[self._next_dispatch_worker].put((seq, indices))
        self._next_dispatch_worker = \
            (self._next_dispatch_worker + 1) % len(self._workers)
        self._outstanding += 1
        return True

    def _check_workers_alive(self) -> None:
        for w in self._workers:
            if not w.is_alive():
                code = w.exitcode
                self.shutdown()
                raise RuntimeError(
                    f"DataLoader worker pid={w.pid} died unexpectedly "
                    f"(exitcode={code}); batch stream is broken.")

    def __iter__(self):
        return self

    def __next__(self):
        while self._outstanding < self._max_outstanding:
            if not self._dispatch_one():
                break
        if self._outstanding == 0:
            self.shutdown()
            raise StopIteration
        limit = _wait_limit(self._timeout)
        while self._next_yield not in self._reorder:
            try:
                seq, payload, err = self._result_q.get(
                    timeout=self._GET_TIMEOUT if limit is None else
                    min(self._GET_TIMEOUT, self._timeout))
            except queue.Empty:
                self._check_workers_alive()
                _check_wait(limit, self._timeout, self.shutdown)
                continue
            if err is not None:
                self.shutdown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            self._reorder[seq] = payload
        payload = self._reorder.pop(self._next_yield)
        self._next_yield += 1
        self._outstanding -= 1
        self._dispatch_one()
        return _decode(payload)

    def shutdown(self) -> None:
        if self._finished:
            return
        self._finished = True
        for q in self._index_qs:
            try:
                q.put(None)
            except (OSError, ValueError) as e:
                # a closed queue: its worker is gone already
                _note_swallowed("shutdown_put", e)
        leftovers = list(self._reorder.values())
        self._reorder.clear()
        _drain_and_reap(self._result_q, self._workers, leftovers)
        for q in self._index_qs + [self._result_q]:
            q.close()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — a finalizer must not raise
            pass


class IterableMultiprocessIter:
    """Multiprocess iterator over an IterableDataset: one bounded queue
    per worker (``maxsize=prefetch_factor``), popped in turn (worker 0,
    1, ...), a deterministic merge with per-worker backpressure and no
    buffering in the parent."""

    _GET_TIMEOUT = 5.0

    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 drop_last: bool, num_workers: int,
                 mp_start_method: str = "fork", seed: int = 0,
                 prefetch_factor: int = 2, auto_shard: bool = True,
                 timeout: float = 0.0) -> None:
        ctx = get_context(mp_start_method)
        self._result_qs = [ctx.Queue(maxsize=max(1, prefetch_factor))
                           for _ in range(num_workers)]
        self._stop_event = ctx.Event()
        self._workers = []
        self._finished = False
        for wid in range(num_workers):
            w = ctx.Process(
                target=_iterable_worker_loop,
                args=(dataset, collate_fn, batch_size, drop_last,
                      self._result_qs[wid], wid, num_workers, seed,
                      auto_shard, self._stop_event),
                daemon=True)
            w.start()
            self._workers.append(w)
        self._n = num_workers
        self._next_worker = 0
        self._done = [False] * num_workers
        self._timeout = float(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        limit = _wait_limit(self._timeout)
        while True:
            if all(self._done):
                self.shutdown()
                raise StopIteration
            while self._done[self._next_worker]:
                self._next_worker = (self._next_worker + 1) % self._n
            wid = self._next_worker
            try:
                _, payload, err = self._result_qs[wid].get(
                    timeout=self._GET_TIMEOUT if limit is None else
                    min(self._GET_TIMEOUT, self._timeout))
            except queue.Empty:
                w = self._workers[wid]
                if not w.is_alive() and self._result_qs[wid].empty():
                    code = w.exitcode
                    self.shutdown()
                    raise RuntimeError(
                        f"DataLoader worker pid={w.pid} died unexpectedly "
                        f"(exitcode={code}); batch stream is broken.")
                _check_wait(limit, self._timeout, self.shutdown)
                continue
            if err == "__done__":
                self._done[wid] = True
                self._next_worker = (wid + 1) % self._n
                continue
            if err is not None:
                self.shutdown()
                raise RuntimeError(f"DataLoader worker failed:\n{err}")
            self._next_worker = (wid + 1) % self._n
            return _decode(payload)

    def shutdown(self) -> None:
        if self._finished:
            return
        self._finished = True
        self._stop_event.set()
        _drain_and_reap(self._result_qs, self._workers, [])

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — a finalizer must not raise
            pass

