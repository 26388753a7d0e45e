"""Data pipeline: datasets, samplers, the DataLoader and the feed to the
card.

Counterpart of ``paddle_tpu.data``. The samplers draw from numpy's
``default_rng``, as the JAX package's do, so one seed gives the JAX
package's batch order exactly. ``DataLoader`` yields batches of CPU
tensors (``default_collate_fn`` stacks samples into tensors; a numpy
array a custom collate returns becomes a tensor), produced inline
(``num_workers=0``) or by worker processes that ship them through shared
memory (``data.worker``), in the sampler's order whatever the number of
workers. ``iter_from(k)`` resumes an epoch at batch ``k`` without
fetching the batches before it.

``DeviceLoader`` moves the batches to the card ahead of their use: each
batch is staged in the pinned ``core.arena.HostStagingArena`` (so its
copies are asynchronous DMAs: a copy from pageable memory is not; the
``allocator_strategy`` flag does not change this) and copied on a side
stream, ``buffer_size`` batches in flight. An event recorded after a
batch's copies is what the consumer's stream waits on when the batch is
handed out, and each of its tensors is marked as used on the consumer's
stream (``record_stream``), so its memory is not reused before the
consumer's work on it is done. On the CPU it hands batches out as they come.

With FLAGS_enable_metrics on, iterating a ``DataLoader`` counts
``data_batches_total`` and observes ``data_batch_wait_seconds`` (how
long the consumer waited on the pipeline for each batch), as the JAX
loader does.

The file-driven path is ``data.dataset`` (``QueueDataset``,
``InMemoryDataset``, ``DatasetFactory`` over the native feed) with
``data.data_generator`` writing its slot files.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core.place import DeviceLike, resolve_device
from ..observability import metrics as _obs_metrics
from .worker import get_worker_info

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "Sampler",
           "SequenceSampler", "RandomSampler", "DistributedBatchSampler",
           "BatchSampler", "default_collate_fn", "DataLoader",
           "DeviceLoader", "get_worker_info", "DatasetBase",
           "QueueDataset", "InMemoryDataset", "DatasetFactory"]


class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx: int):
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class IterableDataset:
    def __iter__(self):
        raise NotImplementedError


class TensorDataset(Dataset):
    """Same-length arrays or tensors, as ``TensorDataset([x, y])`` or
    ``TensorDataset(x, y)``; sample ``i`` is ``(x[i], y[i])``. The list
    form is a list OF arrays: wrap one 2-D array as
    ``TensorDataset(arr)``."""

    def __init__(self, *arrays) -> None:
        if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
            arrays = tuple(arrays[0])
        self.arrays = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                       for a in arrays]
        if any(a.ndim == 0 for a in self.arrays):
            raise ValueError(
                "TensorDataset entries must be indexable along a first "
                "dimension; got a scalar (pass arrays, e.g. "
                "TensorDataset([x, y]) or TensorDataset(x, y))")
        if any(len(a) != len(self.arrays[0]) for a in self.arrays[1:]):
            raise ValueError(
                "TensorDataset arrays must share their first dimension: "
                f"got lengths {[len(a) for a in self.arrays]}")

    def __getitem__(self, idx: int):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self) -> int:
        return len(self.arrays[0])


class Sampler:
    def __init__(self, data_source=None) -> None:
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    """A permutation per ``iter()`` (or draws with ``replacement``) from
    one ``np.random.default_rng(seed)`` made at construction."""

    def __init__(self, data_source, replacement: bool = False,
                 seed: Optional[int] = None) -> None:
        super().__init__(data_source)
        self.replacement = replacement
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(self.rng.integers(0, n, size=n).tolist())
        return iter(self.rng.permutation(n).tolist())

    def __len__(self):
        return len(self.data_source)


class DistributedBatchSampler(Sampler):
    """Shards batches across data-parallel ranks: the indices (shuffled
    by ``default_rng(seed + epoch)``) padded to a multiple of the
    replicas, rank ``r`` taking every ``num_replicas``-th from ``r``."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 rank: int = 0, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.seed = seed

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        # pad so each replica sees the same number of samples
        per_replica = int(np.ceil(n / self.num_replicas))
        padded = np.concatenate([idx, idx[:per_replica * self.num_replicas
                                          - n]])
        local = padded[self.rank::self.num_replicas]
        batches = [local[i:i + self.batch_size].tolist()
                   for i in range(0, len(local), self.batch_size)]
        if self.drop_last and batches and \
                len(batches[-1]) < self.batch_size:
            batches.pop()
        return iter(batches)

    def __len__(self):
        per_replica = int(np.ceil(len(self.dataset) / self.num_replicas))
        if self.drop_last:
            return per_replica // self.batch_size
        return int(np.ceil(per_replica / self.batch_size))


class BatchSampler(Sampler):
    def __init__(self, sampler=None, dataset=None, batch_size: int = 1,
                 shuffle: bool = False, drop_last: bool = False) -> None:
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch: Sequence[Any]):
    """Stacks samples into a batch of CPU tensors, recursing into tuples,
    lists and dicts."""
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(list(batch))
    return torch.from_numpy(np.stack([np.asarray(b) for b in batch]))


def _as_tensors(tree):
    """A batch with every numpy array as a CPU tensor."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return tree


class DataLoader:
    """Batches of a dataset as CPU tensors. ``num_workers=0``: produced
    in the calling thread; ``num_workers>0``: by that many worker
    processes (``data.worker``), in the sampler's order, a dead or
    failing worker raising instead of hanging; ``timeout`` (seconds, 0
    for none) bounds the wait for one batch from the workers."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, batch_sampler=None,
                 prefetch_factor: int = 2, places=None,
                 return_list: bool = True,
                 mp_start_method: str = "fork",
                 worker_auto_shard: bool = True,
                 timeout: float = 0.0) -> None:
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)
        self.mp_start_method = mp_start_method
        self.worker_auto_shard = worker_auto_shard
        self.timeout = float(timeout)
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif isinstance(dataset, IterableDataset):
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, batch_size=batch_size, shuffle=shuffle,
                drop_last=drop_last)

    def _iter_batches(self):
        if self.batch_sampler is None:
            # iterable dataset: batch on the fly
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def _workers(self, batch_indices):
        """Batches of ``batch_indices`` (index lists) from the worker
        processes, shut down when the generator is closed."""
        from .worker import MultiprocessIter
        it = MultiprocessIter(
            self.dataset, self.collate_fn, batch_indices, self.num_workers,
            prefetch_factor=self.prefetch_factor,
            mp_start_method=self.mp_start_method, timeout=self.timeout)
        try:
            yield from it
        finally:
            it.shutdown()

    def _iter_raw(self):
        if self.num_workers <= 0:
            yield from self._iter_batches()
            return
        if self.batch_sampler is not None:
            yield from self._workers(list(self.batch_sampler))
            return
        from .worker import IterableMultiprocessIter
        it = IterableMultiprocessIter(
            self.dataset, self.collate_fn, self.batch_size,
            self.drop_last, self.num_workers,
            mp_start_method=self.mp_start_method,
            prefetch_factor=self.prefetch_factor,
            auto_shard=self.worker_auto_shard, timeout=self.timeout)
        try:
            yield from it
        finally:
            it.shutdown()

    def __iter__(self):
        if not _obs_metrics.enabled():
            for batch in self._iter_raw():
                yield _as_tensors(batch)
            return
        # count batches and measure how long the consumer waited on the
        # pipeline for each one
        batches = _obs_metrics.counter(
            "data_batches_total", "batches produced by DataLoader")
        wait_h = _obs_metrics.histogram(
            "data_batch_wait_seconds",
            "time the training loop waited on the data pipeline")
        it = self._iter_raw()
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                wait_h.observe(time.perf_counter() - t0)
                batches.inc()
                yield _as_tensors(b)
        finally:
            it.close()

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)

    def iter_from(self, batch_offset: int):
        """One epoch's batches from ``batch_offset`` on, the earlier ones
        skipped WITHOUT fetching or collating them (the resume path). The
        batch sampler is still drawn for the skipped positions, so a
        seeded shuffle gives exactly the batches the whole epoch would
        have given from ``batch_offset`` on. An iterable dataset has no
        sampler: its samples are drawn to advance the stream, and only
        collation is skipped."""
        batch_offset = max(0, int(batch_offset))
        if batch_offset == 0:
            yield from self
            return
        if self.batch_sampler is None:
            for j, batch in enumerate(self._iter_batches()):
                if j >= batch_offset:
                    yield _as_tensors(batch)
            return
        indices = list(self.batch_sampler)[batch_offset:]
        if not indices:
            return
        if self.num_workers > 0:
            for batch in self._workers(indices):
                yield _as_tensors(batch)
            return
        for batch_indices in indices:
            yield _as_tensors(self.collate_fn([self.dataset[i]
                                               for i in batch_indices]))


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    return [t for v in items for t in _tensors(v)]


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


class DeviceLoader:
    """Prefetches ``buffer_size`` batches of ``loader`` onto ``device``
    (default: the card) ahead of their use, staged in pinned host
    blocks on the card (see the module note). ``wait_ms`` lists the host
    time each handed-out batch waited for the loader."""

    def __init__(self, loader: Iterable, buffer_size: int = 2,
                 device: DeviceLike = None) -> None:
        self.loader = loader
        self.buffer_size = max(1, int(buffer_size))
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        self._arena = None
        if on_card:
            from ..core.arena import HostStagingArena
            # in flight: the prefetch ring and the batch being consumed
            self._arena = HostStagingArena(depth=self.buffer_size + 2)
        self.wait_ms: List[float] = []

    @property
    def arena(self):
        return self._arena

    def _put(self, batch):
        """``(device batch, event after its copies)``; on the CPU the
        batch as it is and no event."""
        if self._stream is None:
            return _map(lambda t: t.to(self.device), batch), None
        batch = self._arena.stage(batch)
        # the copies wait for nothing queued on the consumer's stream: the
        # point is to overlap them with its work
        with torch.cuda.stream(self._stream):
            out = _map(lambda t: t.to(self.device, non_blocking=True),
                       batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        # the staged views are recycled once the copies are done
        self._arena.advance(event)
        return out, event

    def _hand_out(self, item):
        out, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in _tensors(out):
                if t.is_cuda:
                    t.record_stream(consumer)
        return out

    def __iter__(self):
        it = iter(self.loader)
        buf: List[Any] = []
        self.wait_ms = []
        t0 = time.perf_counter()
        for batch in itertools.islice(it, self.buffer_size):
            buf.append(self._put(batch))
        while buf:
            item = buf.pop(0)
            for batch in itertools.islice(it, 1):
                buf.append(self._put(batch))
            self.wait_ms.append((time.perf_counter() - t0) * 1e3)
            yield self._hand_out(item)
            t0 = time.perf_counter()

    def __len__(self):
        return len(self.loader)


from .dataset import (DatasetBase, DatasetFactory,  # noqa: E402,F401
                      InMemoryDataset, QueueDataset)
from . import data_generator  # noqa: E402,F401
