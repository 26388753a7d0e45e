"""Reader decorators and ``batch``: the 1.x composable data-reader toolkit.

Counterpart of ``paddle_tpu.reader`` (``cache``, ``map_readers``,
``shuffle``, ``chain``, ``compose``, ``buffered``, ``firstn``,
``xmap_readers``, ``batch``), with the same observability series in the
port's ``observability.metrics``: ``reader_buffer_wait_seconds`` (the
consumer's wait on ``buffered``'s queue) and ``reader_batches_total``.

A *reader creator* is a zero-arg callable returning an iterator of
samples. Every decorator here takes and returns reader creators. The
heavyweight path (worker processes and shared memory) is
``data.DataLoader``; these compose before it (``xmap_readers`` runs its
mapper in threads: the usual use is IO-bound decode where the GIL
releases).
"""

from __future__ import annotations

import itertools
import queue as queue_mod
import random as _random_mod
import threading
import time
from typing import Callable

from .observability import metrics as _obs_metrics

__all__ = ["cache", "map_readers", "shuffle", "chain", "compose",
           "buffered", "firstn", "xmap_readers", "batch"]


def cache(reader: Callable) -> Callable:
    """(ref: decorator.py cache) materialize once, replay from memory."""
    all_data = tuple(reader())

    def creator():
        return iter(all_data)

    return creator


def map_readers(func: Callable, *readers: Callable) -> Callable:
    """(ref: decorator.py map_readers) zip readers, map func over the
    per-position samples."""

    def creator():
        its = [r() for r in readers]
        for items in zip(*its):
            yield func(*items)

    return creator


def shuffle(reader: Callable, buf_size: int) -> Callable:
    """(ref: decorator.py shuffle) buffered shuffle: fill a buf_size
    window, emit it shuffled, repeat."""

    def creator():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                _random_mod.shuffle(buf)
                for s in buf:
                    yield s
                buf = []
        if buf:
            _random_mod.shuffle(buf)
            for s in buf:
                yield s

    return creator


def chain(*readers: Callable) -> Callable:
    """(ref: decorator.py chain) concatenate readers back to back."""

    def creator():
        return itertools.chain(*(r() for r in readers))

    return creator


def compose(*readers: Callable, check_alignment: bool = True) -> Callable:
    """(ref: decorator.py compose) zip readers into flattened tuples:
    readers yielding (a) and (b, c) compose to (a, b, c)."""

    def to_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    _missing = object()

    def creator():
        its = [r() for r in readers]
        # zip_longest, not zip: plain zip consumes one extra sample
        # from earlier readers before noticing a shorter one, so an
        # off-by-one misalignment would pass the residue check
        # (ref raises ComposeNotAligned for ANY length mismatch)
        for items in itertools.zip_longest(*its, fillvalue=_missing):
            if any(i is _missing for i in items):
                if check_alignment:
                    raise ValueError(
                        "compose: readers have different lengths "
                        "(ref ComposeNotAligned)")
                return
            yield sum((to_tuple(i) for i in items), ())

    return creator


def buffered(reader: Callable, size: int) -> Callable:
    """(ref: decorator.py buffered) background-thread prefetch of up to
    `size` samples (decouples producer and consumer pace)."""

    class _End:
        pass

    def creator():
        q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
        err = []
        stop = threading.Event()

        def produce():
            try:
                for sample in reader():
                    while not stop.is_set():
                        try:
                            q.put(sample, timeout=0.1)
                            break
                        except queue_mod.Full:
                            continue
                    if stop.is_set():
                        return  # consumer abandoned the generator
            except Exception as e:  # noqa: BLE001
                err.append(e)
            finally:
                # The sentinel must use the same stop-aware retry loop
                # as samples: with a full queue and a merely-slow (not
                # gone) consumer, put_nowait would drop it — the
                # consumer would drain the queue then block in q.get()
                # forever and the stored exception would never surface.
                while not stop.is_set():
                    try:
                        q.put(_End, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
        t = threading.Thread(target=produce, daemon=True)
        t.start()
        # wait-time accounting: enabled-state snapshotted per iteration
        # start, so the hot loop pays one None check when metrics are off
        wait_h = _obs_metrics.histogram(
            "reader_buffer_wait_seconds",
            "consumer wait on the buffered() prefetch queue") \
            if _obs_metrics.enabled() else None
        try:
            while True:
                if wait_h is not None:
                    t0 = time.perf_counter()
                    item = q.get()
                    wait_h.observe(time.perf_counter() - t0)
                else:
                    item = q.get()
                if item is _End:
                    break
                yield item
            if err:
                raise err[0]
        finally:
            # early exit (break/firstn/GC): unblock the producer so it
            # exits instead of deadlocking on a full queue forever
            stop.set()

    return creator


def firstn(reader: Callable, n: int) -> Callable:
    """(ref: decorator.py firstn) truncate to the first n samples."""

    def creator():
        return itertools.islice(reader(), n)

    return creator


def xmap_readers(mapper: Callable, reader: Callable, process_num: int,
                 buffer_size: int, order: bool = False) -> Callable:
    """(ref: decorator.py xmap_readers) apply `mapper` with a pool of
    worker THREADS (the reference's "process_num" are threads too —
    decorator.py:364); `order=True` preserves input order."""

    class _End:
        pass

    def creator():
        in_q: queue_mod.Queue = queue_mod.Queue(buffer_size)
        out_q: queue_mod.Queue = queue_mod.Queue(buffer_size)
        errs = []

        stop = threading.Event()

        def _put(q, item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    if not _put(in_q, (i, sample)):
                        return  # consumer abandoned
            except Exception as e:  # noqa: BLE001
                errs.append(e)
            finally:
                for _ in range(process_num):
                    if not _put(in_q, _End):
                        break

        def _get(q):
            while not stop.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue_mod.Empty:
                    continue
            return _End

        def work():
            while True:
                item = _get(in_q)
                if item is _End:
                    _put(out_q, _End)
                    return
                i, sample = item
                try:
                    if not _put(out_q, (i, mapper(sample))):
                        return
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
                    _put(out_q, _End)
                    return

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        done = 0
        try:
            if order:
                pending = {}
                want = 0
                while done < process_num:
                    item = out_q.get()
                    if item is _End:
                        done += 1
                        continue
                    i, mapped = item
                    pending[i] = mapped
                    while want in pending:
                        yield pending.pop(want)
                        want += 1
                # drain stragglers in order
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            else:
                while done < process_num:
                    item = out_q.get()
                    if item is _End:
                        done += 1
                        continue
                    yield item[1]
            if errs:
                raise errs[0]
        finally:
            # abandonment (break/GC mid-iteration): release every
            # blocked producer/worker instead of deadlocking them
            stop.set()

    return creator


def batch(reader: Callable, batch_size: int,
          drop_last: bool = False) -> Callable:
    """(ref: batch.py batch) group samples into lists of batch_size."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")

    def creator():
        counter = _obs_metrics.counter(
            "reader_batches_total", "batches produced by reader.batch") \
            if _obs_metrics.enabled() else None
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                if counter is not None:
                    counter.inc()
                yield buf
                buf = []
        if buf and not drop_last:
            if counter is not None:
                counter.inc()
            yield buf

    return creator
