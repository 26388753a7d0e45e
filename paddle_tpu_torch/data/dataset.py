"""File-driven training datasets.

Counterpart of ``paddle_tpu.data.dataset`` (the reference's
``fluid/dataset.py``: ``DatasetFactory``, ``InMemoryDataset``,
``QueueDataset``; C++ ``DatasetImpl`` and ``MultiSlotDataFeed``).
Parsing, shuffling and batching run in the native feed
(``native.NativeDataFeed`` over ``csrc/data_feed.cc``) on reader
threads; a batch is a dict of numpy arrays (a dense slot float32 ``[rows,
dim]``, reshaped when its slot names a ``shape``; a sparse one int64
``[rows, dim]`` zero-padded, with ``<name>_len``). On the card such
batches go behind a ``data.DeviceLoader`` (``hapi.Model.fit`` puts every
loader there), so they reach a captured step as staged device copies.

Slot model: each line holds every slot in declaration order, ``<count>
v...`` per slot (the MultiSlot format ``data_generator`` writes).

``InMemoryDataset.local_shuffle(seed)`` permutes the loaded records with
the feed's ``std::mt19937_64``, so the JAX package's feed over the same
files gives the same order (with one reader thread, or one file: several
threads load several files in the order they finish);
``global_shuffle`` exchanges record ranges between workers through the
control plane's ``native.ControlPlaneClient``. Not ported: the static
``Executor.train_from_dataset`` (A17).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import native

__all__ = ["DatasetBase", "QueueDataset", "InMemoryDataset",
           "DatasetFactory"]


class _SlotDef:
    def __init__(self, name: str, kind: str, dim: int,
                 shape: Optional[Tuple[int, ...]] = None) -> None:
        self.name, self.kind, self.dim = name, kind, dim
        self.shape = shape  # optional reshape of a dense slot


class DatasetBase:
    """The configuration every dataset shares (the reference's
    ``DatasetBase`` setters)."""

    def __init__(self) -> None:
        self._slots: List[_SlotDef] = []
        self._batch_size = 1
        self._thread = 1
        self._filelist: List[str] = []
        self._queue_capacity = 64
        self._feed: Optional[native.NativeDataFeed] = None

    def set_batch_size(self, batch_size: int) -> None:
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num: int) -> None:
        self._thread = int(thread_num)

    def set_filelist(self, filelist: Sequence[str]) -> None:
        self._filelist = list(filelist)

    def set_queue_capacity(self, capacity: int) -> None:
        self._queue_capacity = int(capacity)

    def set_slots(self, slots: Sequence) -> None:
        """Declares the input slots, in file order: each a ``(name, kind,
        dim)`` tuple or a dict with those keys and an optional ``shape``
        for a dense slot (e.g. ``(1, 28, 28)``)."""
        defs = []
        for s in slots:
            if isinstance(s, dict):
                defs.append(_SlotDef(s["name"], s["kind"], int(s["dim"]),
                                     tuple(s["shape"]) if s.get("shape")
                                     else None))
            else:
                name, kind, dim = s
                defs.append(_SlotDef(name, kind, int(dim)))
        self._slots = defs

    # the reference's name for declaring what the program reads
    set_use_var = set_slots

    def slot_names(self) -> List[str]:
        return [s.name for s in self._slots]

    def _make_feed(self) -> native.NativeDataFeed:
        if not self._slots:
            raise ValueError("dataset has no slots; call set_slots first")
        specs = [native.SlotSpec(s.name, s.kind, s.dim) for s in self._slots]
        feed = native.NativeDataFeed(specs, batch_size=self._batch_size,
                                     num_threads=self._thread,
                                     queue_capacity=self._queue_capacity)
        feed.set_files(self._filelist)
        return feed

    def _feed_or_make(self) -> native.NativeDataFeed:
        if self._feed is None:
            self._feed = self._make_feed()
        return self._feed

    def _postprocess(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        for s in self._slots:
            if s.kind == "dense" and s.shape is not None:
                b = batch[s.name]
                batch[s.name] = b.reshape((b.shape[0],) + s.shape)
        return batch

    def release(self) -> None:
        if self._feed is not None:
            self._feed.close()
            self._feed = None


class QueueDataset(DatasetBase):
    """Streaming: reader threads parse the files straight into the batch
    queue each epoch."""

    def __iter__(self):
        feed = self._feed_or_make()
        feed.set_files(self._filelist)
        feed.start()
        for batch in feed:
            yield self._postprocess(batch)


class InMemoryDataset(DatasetBase):
    """Loaded once, shuffled locally, batched from memory each epoch."""

    def __init__(self) -> None:
        super().__init__()
        self._epoch = 0
        self._shuffle_round = 0

    def load_into_memory(self) -> int:
        feed = self._feed_or_make()
        feed.set_files(self._filelist)
        return feed.load_into_memory()

    def get_memory_data_size(self) -> int:
        return self._feed_or_make().memory_size()

    def local_shuffle(self, seed: Optional[int] = None) -> None:
        """Permutes the records in memory (``seed`` None: the round
        number, as in the JAX package)."""
        if seed is None:
            seed = self._shuffle_round
        self._shuffle_round += 1
        self._feed_or_make().local_shuffle(seed)

    def global_shuffle(self, client, rank: int, world: int,
                       timeout_ms: int = 120000) -> int:
        """Shuffles the records across ``world`` workers through the
        control plane (``native.ControlPlaneClient``), as the JAX package
        does: every worker local-shuffles (seed ``round * 1000003 + 17``),
        splits its records into ``world`` contiguous chunks, publishes
        chunk d under ``gshuf/<round>/<rank>-><d>``, meets the others at a
        barrier, rebuilds its memory from every chunk sent to it (in
        source order), meets them again, and local-shuffles (seed ``round *
        7919 + rank``). Returns the new local record count. The same seeds
        and files give each rank the JAX package's record set."""
        feed = self._feed_or_make()
        rnd = self._shuffle_round
        self._shuffle_round += 1
        feed.local_shuffle(rnd * 1000003 + 17)
        n = feed.memory_size()
        bounds = [int(round(i * n / world)) for i in range(world + 1)]
        for dst in range(world):
            blob = feed.serialize_range(bounds[dst], bounds[dst + 1])
            client.set(f"gshuf/{rnd}/{rank}->{dst}", blob)
        client.barrier(f"gshuf/{rnd}/posted", world, timeout_ms)
        feed.clear_memory()
        total = 0
        for src in range(world):
            blob = client.get(f"gshuf/{rnd}/{src}->{rank}", block=True,
                              timeout_ms=timeout_ms)
            total += feed.deserialize_append(blob)
        client.barrier(f"gshuf/{rnd}/done", world, timeout_ms)
        feed.local_shuffle(rnd * 7919 + rank)
        return total

    def release_memory(self) -> None:
        self._feed_or_make().clear_memory()

    def __iter__(self):
        feed = self._feed_or_make()
        feed.start_from_memory()
        self._epoch += 1
        for batch in feed:
            yield self._postprocess(batch)


class DatasetFactory:
    """``create_dataset("InMemoryDataset" | "QueueDataset")``."""

    _KINDS = {"InMemoryDataset": InMemoryDataset,
              "QueueDataset": QueueDataset}

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class not in self._KINDS:
            raise ValueError(
                f"unknown dataset class {datafeed_class!r}; "
                f"choose from {sorted(self._KINDS)}")
        return self._KINDS[datafeed_class]()
