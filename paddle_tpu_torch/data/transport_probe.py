"""Measures the worker-to-parent batch transport beside a checkpoint
writer: where the pickle queue and shared memory cross in size, and
which step of the shared-memory path stalls while a writer thread
writes a checkpoint.

Run on a machine with a card, from the root of the repo::

    python -m paddle_tpu_torch.data.transport_probe [--ckpt-gb 1.5]

It prints one JSON report and writes it to
``chiprun_out/transport_probe.json``. Conditions: ``idle``, and
``writing`` (an ``io.AsyncCheckpointer`` saving a tree of ``--ckpt-gb``
GB of fp32 tensors on the card, again and again, for the whole
measurement). In each condition and for each array size:

- ``fetch``: a ``DataLoader`` with 2 forked workers yields batches of
  six arrays of that size, once through the pickle queue and once
  through shared memory (``worker._SHM_MIN_BYTES`` set below and above
  the size); the consumer sleeps ``STEP_S`` between fetches, as a
  training step would, and each fetch's wait is timed;
- ``steps``: the shared-memory path's steps timed one by one in this
  process: create the segment (``shm_open``, ``ftruncate``, ``mmap``),
  copy into it (the first touch of its pages), attach, copy out,
  ``munmap`` and unlink; and the same bytes through a pipe.

The report also holds the memory limits and the dirty and writeback
page counts of the machine before and during the writes, and the file
system of the checkpoint directory.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import threading
import time
from multiprocessing.shared_memory import SharedMemory

import numpy as np
import torch

from .. import io
from . import DataLoader
from . import worker as _worker

SIZES = (32 << 10, 256 << 10, 1 << 20, 4 << 20)
FIELDS = 6  # a BERT pretraining batch's arrays
BATCH = 8
BATCHES = 24
STEP_S = 0.04  # the consumer's work between fetches (~a BERT-base step)
REPS = 30


class _Arrays:
    """Samples of FIELDS int64 arrays; a batch of BATCH stacks each field
    into ``nbytes`` bytes."""

    def __init__(self, nbytes: int, n: int) -> None:
        self.n = n
        self.row = nbytes // BATCH // 8

    def __getitem__(self, i):
        return tuple(np.full(self.row, i * FIELDS + f, np.int64)
                     for f in range(FIELDS))

    def __len__(self):
        return self.n


def _stats(ms) -> dict:
    ms = sorted(ms)
    return {"median_ms": float(np.median(ms)), "max_ms": float(ms[-1]),
            "p90_ms": float(ms[int(0.9 * (len(ms) - 1))])}


def _fetch(nbytes: int, shm: bool) -> dict:
    """Fetch waits of BATCHES batches through 2 workers."""
    old = _worker._SHM_MIN_BYTES
    _worker._SHM_MIN_BYTES = 0 if shm else 1 << 62
    try:
        loader = DataLoader(_Arrays(nbytes, BATCH * BATCHES),
                            batch_size=BATCH, num_workers=2, timeout=60.0)
        waits = []
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            waits.append((time.perf_counter() - t0) * 1e3)
            assert batch[0].numel() * 8 == nbytes
            time.sleep(STEP_S)
    finally:
        _worker._SHM_MIN_BYTES = old
    return _stats(waits[1:])  # the first waits for the workers to start


def _steps(nbytes: int) -> dict:
    """The shared-memory path's steps one by one, and a pipe round trip
    of the same bytes, REPS times each."""
    arr = np.arange(nbytes // 8, dtype=np.int64)
    names = ("create", "copy_in", "attach", "copy_out", "close_unlink",
             "pipe")
    ms = {k: [] for k in names}
    recv, send = multiprocessing.Pipe(duplex=False)
    for _ in range(REPS):
        t = [time.perf_counter()]
        seg = SharedMemory(create=True, size=nbytes)
        t.append(time.perf_counter())
        np.ndarray(arr.shape, arr.dtype, buffer=seg.buf)[:] = arr
        t.append(time.perf_counter())
        other = SharedMemory(name=seg.name)
        t.append(time.perf_counter())
        out = np.array(np.ndarray(arr.shape, arr.dtype, buffer=other.buf))
        t.append(time.perf_counter())
        other.close()
        seg.close()
        seg.unlink()
        t.append(time.perf_counter())
        sender = threading.Thread(target=send.send_bytes,
                                  args=(arr.tobytes(),))
        sender.start()
        got = recv.recv_bytes()
        sender.join()
        t.append(time.perf_counter())
        assert out[-1] == arr[-1] and len(got) == nbytes
        for k, a, b in zip(names, t, t[1:]):
            ms[k].append((b - a) * 1e3)
    recv.close()
    send.close()
    return {k: _stats(v) for k, v in ms.items()}


def _memory() -> dict:
    """The cgroup's limit and use, and the machine's dirty and writeback
    pages (kB), where the files exist."""
    out = {}
    for name in ("memory.max", "memory.current", "memory.high"):
        try:
            with open(f"/sys/fs/cgroup/{name}") as f:
                out[name] = f.read().strip()
        except OSError:
            pass
    try:
        with open("/sys/fs/cgroup/memory.stat") as f:
            for line in f:
                k, v = line.split()
                if k in ("file", "file_dirty", "file_writeback", "shmem"):
                    out[f"cgroup_{k}"] = int(v)
    except OSError:
        pass
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            if k in ("MemTotal", "MemFree", "Dirty", "Writeback",
                     "Shmem"):
                out[k + "_kB"] = int(v.split()[0])
    return out


def _filesystem(path: str) -> str:
    path = os.path.realpath(path)
    best = ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fstype = line.split()[:3]
            if path.startswith(mnt) and len(mnt) > len(best[0]):
                best = (mnt, fstype)
    return f"{best[1]} at {best[0]}"


def _measure() -> dict:
    return {str(n): {"fetch_queue": _fetch(n, shm=False),
                     "fetch_shm": _fetch(n, shm=True),
                     "steps": _steps(n)} for n in SIZES}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-gb", type=float, default=1.5)
    ap.add_argument("--ckpt-dir", default="chip_smoke_ckpt/transport")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("transport_probe: no card")
        return 1
    report = {"card": torch.cuda.get_device_name(0),
              "step_s": STEP_S, "batches": BATCHES, "fields": FIELDS,
              "filesystem": _filesystem(os.path.dirname(
                  os.path.abspath(args.ckpt_dir)) or "."),
              "memory_idle": _memory(), "idle": _measure()}
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    leaf = int(args.ckpt_gb * 1e9 / 4 / 4)
    state = {f"w{i}": torch.randn(leaf, device="cuda") for i in range(4)}
    ck = io.AsyncCheckpointer(args.ckpt_dir, max_to_keep=1)
    stop = threading.Event()
    writes = []

    def keep_writing() -> None:
        step = 0
        while not stop.is_set():
            step += 1
            ck.save(state, step=step)
            ck.wait()
            writes.append(ck.last_write_s)

    writer = threading.Thread(target=keep_writing, daemon=True)
    writer.start()
    time.sleep(0.5)  # the first save's pinning is not what is measured
    mem = [_memory()]
    report["writing"] = _measure()
    mem.append(_memory())
    stop.set()
    writer.join(timeout=120)
    report["memory_writing"] = mem
    report["writer_s"] = writes
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/transport_probe.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
