"""PyTorch port: the file-driven data path against the JAX package on the
CPU.

One ``MultiSlotDataGenerator`` subclass renders the same numpy-seeded
samples through both packages' generators (the slot files must be equal
byte for byte); then ``QueueDataset`` and ``InMemoryDataset`` over those
files (one reader thread, so the record order is the files'), with
``local_shuffle(seed)``, must hand out the JAX package's batches in the
JAX package's order; ``serialize_range`` blobs must be equal and load
into the other package's feed.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from paddle_tpu import data as jdata  # noqa: E402
from paddle_tpu.data import data_generator as jgen  # noqa: E402

from paddle_tpu_torch import data as pdata  # noqa: E402
from paddle_tpu_torch.data import data_generator as pgen  # noqa: E402

SLOTS = [("src", "sparse", 12), ("tgt", "sparse", 9),
         {"name": "feat", "kind": "dense", "dim": 6, "shape": (2, 3)}]
# the same slots with the dense one declared first (see the round trip)
DENSE_FIRST = SLOTS[2:] + SLOTS[:2]
N_LINES = 37


def _generator(base, dense_first=False):
    class Gen(base):
        def generate_sample(self, line):
            def it():
                rng = np.random.default_rng(int(line))
                n = int(rng.integers(1, 13))
                slots = [("src", [int(v) for v in rng.integers(3, 500, n)]),
                         ("tgt", [int(v) for v in rng.integers(3, 500, 9)]),
                         ("feat", [float(v) for v in
                                   np.round(rng.standard_normal(6), 4)])]
                yield slots[2:] + slots[:2] if dense_first else slots
            return it
    return Gen()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("slots")
    inputs = []
    for part in range(2):
        p = d / f"in-{part}.txt"
        p.write_text("".join(f"{part * 100 + i}\n" for i in range(N_LINES)))
        inputs.append(str(p))
    out = {}
    for name, mod in (("jax", jgen), ("port", pgen)):
        for first in (False, True):
            key = name + ("_dense_first" if first else "")
            out[key] = []
            for part, inp in enumerate(inputs):
                dst = str(d / f"{key}-part-{part}")
                gen = _generator(mod.MultiSlotDataGenerator, first)
                gen.set_batch(8)
                gen.run_from_files([inp], dst)
                out[key].append(dst)
    return out


def test_generator_writes_the_jax_slot_files(files):
    for a, b in zip(files["jax"], files["port"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    with open(files["port"][0]) as f:
        first = f.readline().split()
    n = int(first[0])
    assert len(first) == 1 + n + 1 + 9 + 1 + 6


def _make(mod, kind, filelist, batch=5, slots=SLOTS):
    ds = mod.DatasetFactory().create_dataset(kind)
    ds.set_slots(slots)
    ds.set_batch_size(batch)
    ds.set_thread(1)
    ds.set_filelist(filelist)
    return ds


def _equal_batches(got, want):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def test_queue_dataset_batches_match_jax(files):
    want = list(_make(jdata, "QueueDataset", files["jax"][:1]))
    got = list(_make(pdata, "QueueDataset", files["port"][:1]))
    _equal_batches(got, want)
    assert got[0]["feat"].shape == (5, 2, 3)
    assert got[0]["src"].shape == (5, 12) and got[-1]["src"].shape[0] == 2
    assert (got[0]["src_len"] <= 12).all()


@pytest.mark.parametrize("seed", [0, 7])
def test_in_memory_local_shuffle_order_matches_jax(files, seed):
    jds = _make(jdata, "InMemoryDataset", files["jax"])
    pds = _make(pdata, "InMemoryDataset", files["port"])
    assert jds.load_into_memory() == pds.load_into_memory() == 2 * N_LINES
    assert pds.get_memory_data_size() == 2 * N_LINES
    jds.local_shuffle(seed)
    pds.local_shuffle(seed)
    want, got = list(jds), list(pds)
    _equal_batches(got, want)
    # a second epoch from memory is the same order again
    _equal_batches(list(pds), got)
    unshuffled = _make(pdata, "InMemoryDataset", files["port"])
    unshuffled.load_into_memory()
    assert not np.array_equal(list(unshuffled)[0]["tgt"], got[0]["tgt"])


def test_serialize_range_and_deserialize_append_cross_packages(files):
    kw = dict(slots=DENSE_FIRST)
    jds = _make(jdata, "InMemoryDataset", files["jax_dense_first"][:1], **kw)
    pds = _make(pdata, "InMemoryDataset", files["port_dense_first"][:1],
                **kw)
    jds.load_into_memory()
    pds.load_into_memory()
    jfeed, pfeed = jds._feed_or_make(), pds._feed_or_make()
    blob = pfeed.serialize_range(3, 20)
    assert blob == jfeed.serialize_range(3, 20)
    with pytest.raises(ValueError):
        pfeed.serialize_range(20, 3)
    # the port's blob into a fresh JAX feed and the JAX blob into a fresh
    # port feed: the same records
    jnew = _make(jdata, "InMemoryDataset", [], **kw)
    pnew = _make(pdata, "InMemoryDataset", [], **kw)
    assert jnew._feed_or_make().deserialize_append(blob) == 17
    assert pnew._feed_or_make().deserialize_append(
        jfeed.serialize_range(3, 20)) == 17
    _equal_batches(list(pnew), list(jnew))
    with pytest.raises(RuntimeError):
        pnew._feed_or_make().deserialize_append(b"\x01\x02\x03")
    pds.release_memory()
    assert pds.get_memory_data_size() == 0
    pds.release()


def test_round_trip_fails_alike_with_a_sparse_slot_before_a_dense_one(files):
    # csrc/data_feed.cc writes a record's dense slots before its sparse
    # ones but reads them back in declaration order, so with a sparse slot
    # declared first the blob does not load back: a fault of the shared
    # native source (ROADMAP C), which both packages show alike
    for mod, key in ((jdata, "jax"), (pdata, "port")):
        ds = _make(mod, "InMemoryDataset", files[key][:1])
        ds.load_into_memory()
        blob = ds._feed_or_make().serialize_range(0, 4)
        fresh = _make(mod, "InMemoryDataset", [])
        with pytest.raises(RuntimeError, match="corrupt"):
            fresh._feed_or_make().deserialize_append(blob)


def test_global_shuffle_names_what_it_waits_for(files):
    # one worker through each package's control plane: the JAX records in
    # the JAX order (several workers: tests/test_torch_launch.py)
    from paddle_tpu import native as jnative
    from paddle_tpu_torch import native as pnative
    got = {}
    for name, mod, nat in (("jax", jdata, jnative), ("port", pdata,
                                                     pnative)):
        kw = dict(slots=DENSE_FIRST)
        ds = _make(mod, "InMemoryDataset", files[name + "_dense_first"],
                   **kw)
        ds.load_into_memory()
        with nat.ControlPlaneServer() as srv, \
                nat.ControlPlaneClient(port=srv.port) as cli:
            assert ds.global_shuffle(cli, 0, 1) == 2 * N_LINES
        got[name] = list(ds)
    _equal_batches(got["port"], got["jax"])
    with pytest.raises(TypeError):
        _make(pdata, "InMemoryDataset", files["port"]).global_shuffle()
    with pytest.raises(ValueError, match="unknown dataset class"):
        pdata.DatasetFactory().create_dataset("Nope")
    assert os.path.exists(files["port"][0])
