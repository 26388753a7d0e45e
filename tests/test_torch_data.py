"""PyTorch port: the data pipeline (``paddle_tpu_torch.data``) against the
JAX package's on the CPU.

- The port's batches equal the JAX package's batch for batch for one
  seed (``RandomSampler``, ``DistributedBatchSampler``, an iterable
  stream), at ``num_workers`` 0 and 2, as CPU tensors; ``iter_from(k)``
  equals the tail of the whole epoch.
- The multiprocess cases of ``tests/test_dataloader_mp.py`` (its
  wall-clock speedup bound aside): order, shared-memory transport, the
  iterable stream and a self-sharding one, a dead worker, a worker's
  exception, an early break; and a new epoch's workers forked while a
  checkpoint save is in flight, its writer holding a lock.
- The pinned staging arena's recycling (a block returns only after its
  copies' event completed) and ``DeviceLoader`` on the CPU.

Every worker test joins with a bound (the loaders' ``timeout``), so
none can hang.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import os
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu import data as jax_data  # noqa: E402

from paddle_tpu_torch import io  # noqa: E402
from paddle_tpu_torch.core.arena import HostStagingArena  # noqa: E402
from paddle_tpu_torch.data import (BatchSampler, DataLoader,  # noqa: E402
                                   Dataset, DeviceLoader,
                                   DistributedBatchSampler,
                                   IterableDataset, RandomSampler,
                                   TensorDataset, default_collate_fn)
from paddle_tpu_torch.data.worker import get_worker_info  # noqa: E402

WAIT_S = 60.0  # the bound on any wait for a batch from the workers


class Samples(Dataset):
    """Synthetic pretraining samples from a seed: token ids, segment ids,
    mask, MLM labels and an NSP label (numpy)."""

    def __init__(self, n=48, seq=32, seed=0):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(0, 512, (n, seq)).astype(np.int64)
        self.types = rng.integers(0, 2, (n, seq)).astype(np.int64)
        self.mask = np.ones((n, seq), np.int64)
        self.mlm = rng.integers(0, 512, (n, seq)).astype(np.int64)
        self.nsp = rng.integers(0, 2, (n,)).astype(np.int64)

    def __getitem__(self, i):
        return (self.ids[i], self.types[i], self.mask[i], self.mlm[i],
                self.nsp[i])

    def __len__(self):
        return len(self.ids)


class JaxSamples(jax_data.Dataset):
    def __init__(self, inner):
        self.inner = inner

    def __getitem__(self, i):
        return self.inner[i]

    def __len__(self):
        return len(self.inner)


class ArrayDataset(Dataset):
    def __init__(self, n=64, dim=512):
        self.x = np.arange(n * dim, dtype=np.float32).reshape(n, dim)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)

    def __len__(self):
        return len(self.x)


class CountStream(IterableDataset):
    def __init__(self, n=40):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((4,), float(i), np.float32)


class JaxCountStream(jax_data.IterableDataset):
    def __init__(self, n=40):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.full((4,), float(i), np.float32)


class DyingDataset(Dataset):
    def __getitem__(self, i):
        if i == 5 and get_worker_info() is not None:
            os._exit(3)  # hard death: no exception, no cleanup
        return np.zeros((4,), np.float32)

    def __len__(self):
        return 16


def _same(port_batches, jax_batches):
    port_batches, jax_batches = list(port_batches), list(jax_batches)
    assert len(port_batches) == len(jax_batches) > 0
    for p, j in zip(port_batches, jax_batches):
        p = p if isinstance(p, tuple) else (p,)
        j = j if isinstance(j, tuple) else (j,)
        assert len(p) == len(j)
        for a, b in zip(p, j):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            assert np.array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype


# -- the same batches as the JAX package --------------------------------

@pytest.mark.parametrize("workers", [0, 2])
def test_seeded_shuffle_matches_jax_batch_for_batch(workers):
    ds = Samples()

    def port():
        return DataLoader(ds, batch_sampler=BatchSampler(
            RandomSampler(ds, seed=7), batch_size=8, drop_last=True),
            num_workers=workers, timeout=WAIT_S)

    def jx():
        jds = JaxSamples(ds)
        return jax_data.DataLoader(jds, batch_sampler=jax_data.BatchSampler(
            jax_data.RandomSampler(jds, seed=7), batch_size=8,
            drop_last=True))

    _same(port(), jx())
    # iter_from(k): the tail of the whole epoch, and JAX's own tail
    whole = list(port())
    for k in (0, 1, 4, 5):
        tail = list(port().iter_from(k))
        assert len(tail) == len(whole) - k
        _same(tail, [tuple(t.numpy() for t in b) for b in whole[k:]])
        _same(port().iter_from(k), jx().iter_from(k))
    assert list(port().iter_from(len(whole))) == []
    # a second epoch of one loader draws the sampler's next permutation,
    # as the JAX one does
    p, j = port(), jx()
    list(p), list(j)
    _same(p, j)


@pytest.mark.parametrize("workers", [0, 2])
def test_distributed_batch_sampler_matches_jax(workers):
    ds = Samples(n=37)
    jds = JaxSamples(ds)
    for rank in (0, 1, 2):
        for epoch in (0, 3):
            s = DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                        shuffle=True, seed=5)
            js = jax_data.DistributedBatchSampler(jds, 4, num_replicas=3,
                                                  rank=rank, shuffle=True,
                                                  seed=5)
            s.set_epoch(epoch)
            js.set_epoch(epoch)
            assert list(s) == list(js) and len(s) == len(js)
            _same(DataLoader(ds, batch_sampler=s, num_workers=workers,
                             timeout=WAIT_S),
                  jax_data.DataLoader(jds, batch_sampler=js))


def test_plain_loaders_and_collation_match_jax():
    ds = Samples(n=21)
    jds = JaxSamples(ds)
    for kw in (dict(batch_size=4), dict(batch_size=4, drop_last=True)):
        _same(DataLoader(ds, **kw), jax_data.DataLoader(jds, **kw))
    _same(DataLoader(CountStream(), batch_size=6),
          jax_data.DataLoader(JaxCountStream(), batch_size=6))
    _same(DataLoader(CountStream(), batch_size=6).iter_from(2),
          jax_data.DataLoader(JaxCountStream(), batch_size=6).iter_from(2))
    x, y = np.arange(20.0).reshape(10, 2), np.arange(10)
    _same(DataLoader(TensorDataset([x, y]), batch_size=3),
          jax_data.DataLoader(jax_data.TensorDataset([x, y]), batch_size=3))
    batch = default_collate_fn([{"a": np.ones(2), "b": (np.int32(1),
                                                        np.int32(2))}] * 3)
    assert batch["a"].shape == (3, 2) and batch["b"][1].dtype == torch.int32
    t = default_collate_fn([torch.ones(2, dtype=torch.bfloat16)] * 2)
    assert t.dtype == torch.bfloat16 and t.shape == (2, 2)
    with pytest.raises(ValueError, match="first dimension"):
        TensorDataset([np.ones(3), np.ones(4)])
    with pytest.raises(ValueError, match="scalar"):
        TensorDataset(np.float32(1.0))


# -- the multiprocess cases ---------------------------------------------

def test_mp_matches_single_process_order():
    ds = ArrayDataset(64)
    ref = list(DataLoader(ds, batch_size=8, num_workers=0))
    got = list(DataLoader(ds, batch_size=8, num_workers=3, timeout=WAIT_S))
    assert len(ref) == len(got) == 8
    for (rx, ri), (gx, gi) in zip(ref, got):
        assert torch.equal(rx, gx) and torch.equal(ri, gi)


@pytest.mark.parametrize("dim", [512, 8192])
def test_mp_batches_ride_the_queue_or_shared_memory(dim, monkeypatch):
    # 64 x 512 fp32 = 128 KiB per batch array rides the queue, 64 x 8192
    # = 2 MiB a shared-memory segment (the encode/decode path)
    from paddle_tpu_torch.data import worker
    made = []
    real = worker.SharedMemory

    def counting(*a, **k):
        made.append(k.get("create", False))
        return real(*a, **k)

    monkeypatch.setattr(worker, "SharedMemory", counting)
    ds = ArrayDataset(128, dim=dim)
    batches = list(DataLoader(ds, batch_size=64, num_workers=2,
                              timeout=WAIT_S))
    assert batches[0][0].shape == (64, dim)
    assert np.array_equal(torch.cat([b[0] for b in batches]).numpy(), ds.x)
    # the parent opens a segment per large array (the workers made them)
    assert len(made) == (2 if dim * 64 * 4 >= worker._SHM_MIN_BYTES else 0)
    # tensors (bf16 among them) cross too, as tensors
    big = torch.randn(64, dim).to(torch.bfloat16)
    got = list(DataLoader(TensorDataset(big, torch.arange(64)),
                          batch_size=32, num_workers=2, timeout=WAIT_S))
    assert got[0][0].dtype == torch.bfloat16
    assert torch.equal(torch.cat([g[0] for g in got]), big)


def test_mp_iterable_dataset_covers_stream():
    got = list(DataLoader(CountStream(40), batch_size=4, num_workers=2,
                          timeout=WAIT_S))
    vals = sorted(float(v) for b in got for v in b[:, 0])
    assert vals == [float(v) for v in range(40)]
    again = list(DataLoader(CountStream(40), batch_size=4, num_workers=2,
                            timeout=WAIT_S))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_mp_iterable_self_sharding_dataset():
    class SelfSharding(IterableDataset):
        def __iter__(self):
            info = get_worker_info()
            wid = info.id if info else 0
            n = info.num_workers if info else 1
            for i in range(wid, 40, n):
                yield np.full((4,), float(i), np.float32)

    got = list(DataLoader(SelfSharding(), batch_size=4, num_workers=2,
                          worker_auto_shard=False, timeout=WAIT_S))
    vals = sorted(float(v) for b in got for v in b[:, 0])
    assert vals == [float(v) for v in range(40)]


def test_mp_worker_death_raises():
    dl = DataLoader(DyingDataset(), batch_size=4, num_workers=2,
                    timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="died unexpectedly"):
        for _ in dl:
            pass


def test_mp_worker_exception_propagates():
    class Bad(Dataset):
        def __getitem__(self, i):
            if i == 7:
                raise ValueError("bad record 7")
            return np.zeros((4,), np.float32)

        def __len__(self):
            return 16

    dl = DataLoader(Bad(), batch_size=4, num_workers=2, timeout=WAIT_S)
    with pytest.raises(RuntimeError, match="bad record 7"):
        for _ in dl:
            pass


def test_mp_early_break_shuts_down_cleanly():
    ds = ArrayDataset(64)
    for _ in range(3):
        for i, _ in enumerate(DataLoader(ds, batch_size=8, num_workers=2,
                                         timeout=WAIT_S)):
            if i == 1:
                break  # closing the generator reaps the workers
    assert not [c for c in __import__("multiprocessing").active_children()
                if c.is_alive()]


def test_a_wedged_worker_times_out_instead_of_hanging():
    class Wedged(Dataset):
        def __getitem__(self, i):
            if get_worker_info() is not None:
                threading.Event().wait()  # never returns
            return np.zeros(2)

        def __len__(self):
            return 4

    with pytest.raises(RuntimeError, match="timed out"):
        list(DataLoader(Wedged(), batch_size=2, num_workers=1, timeout=1.0))


def test_workers_fork_while_a_checkpoint_save_is_in_flight(tmp_path,
                                                           monkeypatch):
    # the writer holds a lock of its own and waits, mid-save, until a new
    # epoch's workers were forked and delivered every batch
    lock = threading.Lock()
    loaded = threading.Event()
    inside = threading.Event()
    real = io._write

    def slow_write(*a, **k):
        with lock:
            inside.set()
            assert loaded.wait(WAIT_S)
            return real(*a, **k)

    monkeypatch.setattr(io, "_write", slow_write)
    state = {"w": torch.randn(256, 256), "step": torch.tensor(3)}
    ck = io.AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(state, step=3, host_state={"batch_in_epoch": 3})
    assert inside.wait(WAIT_S) and lock.locked()
    ds = ArrayDataset(64)
    got = list(DataLoader(ds, batch_size=8, num_workers=2, timeout=WAIT_S))
    loaded.set()
    ck.wait()
    assert np.array_equal(torch.cat([g[0] for g in got]).numpy(), ds.x)
    assert ck.latest_step() == 3 and ck.verify() == []
    assert torch.equal(io.load(str(tmp_path / "ck" / "ckpt-3"))["w"],
                       state["w"])


# -- the staging arena and the device feed ------------------------------

class FakeEvent:
    def __init__(self):
        self.done = False
        self.waited = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waited += 1
        self.done = True


def test_arena_recycles_a_block_only_after_its_event_completed():
    arena = HostStagingArena(block_bytes=1 << 16, depth=2, pin=False)
    x = {"a": torch.arange(1000, dtype=torch.int64),
         "b": np.ones((3, 5), np.float32)}
    staged = arena.stage(x)
    assert torch.equal(staged["a"], x["a"])
    assert staged["b"].dtype == torch.float32 and staged["b"].sum() == 15
    assert staged["a"].data_ptr() % 4096 == 0
    e1 = FakeEvent()
    arena.advance(e1)
    first = staged["a"].data_ptr()
    # the copy has not completed: staging again takes a new block
    again = arena.stage(x)
    assert again["a"].data_ptr() != first
    assert arena.stats["blocks_allocated"] == 2
    e2 = FakeEvent()
    arena.advance(e2)
    e1.done = True
    third = arena.stage(x)  # e1 completed: its block comes back
    assert third["a"].data_ptr() == first
    assert arena.stats["blocks_reused"] == 1 and e1.waited == 0
    e3 = FakeEvent()
    arena.advance(e3)
    # more than depth generations waiting: the oldest is waited for
    arena.stage(x)
    arena.advance(FakeEvent())
    assert e2.waited == 1
    assert arena.stats["event_waits"] == 1


def test_arena_oversize_tensors_and_the_trim_budget():
    arena = HostStagingArena(block_bytes=4096, depth=2, pin=False)
    big = torch.randn(4096)
    staged = arena.stage(big)
    assert torch.equal(staged, big)
    assert arena.stats["oversize_passthrough"] == 1
    arena.advance(None)
    for _ in range(6):
        arena.stage(torch.ones(10))
        arena.advance(None)  # nothing reads the views any more
    # the oversize buffer was released, not kept: the free list holds
    # the one block the feed's working set needs
    assert len(arena._free) == 1
    assert arena.stats["blocks_allocated"] == 1
    assert arena.stats["blocks_reused"] == 5


def test_device_loader_on_the_cpu_hands_out_the_batches():
    ds = Samples(n=24)
    want = list(DataLoader(ds, batch_size=8))
    feed = DeviceLoader(DataLoader(ds, batch_size=8, num_workers=2,
                                   timeout=WAIT_S), buffer_size=2,
                        device="cpu")
    got = list(feed)
    assert len(feed) == 3 and len(feed.wait_ms) == 3
    assert feed.arena is None  # no host-to-device copy to stage
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_device_loader_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceLoader([])
