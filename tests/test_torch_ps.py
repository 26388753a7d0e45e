"""PyTorch port: ``distributed.ps`` (``PSCluster``, ``DensePSAdapter``,
``SparseEmbeddingPS``, ``PSTrainStep`` sync/async/geo, ``run_server``,
``HeartbeatMonitor``) and ``native.PsServer``/``PsClient``, against the
JAX package.

Both packages drive the same native service (``csrc/ps_service.cc``,
each through its own build of the library). The in-process cases mirror
``tests/test_ps.py`` with the port's bindings and trainer; the trainer's
runs are held against the JAX ``PSTrainStep`` on the same weights and
batches, each against its own server (tolerance ``TOL``, relative to a
parameter's largest entry: the gradients are summed in another order).
The multi-process case (``paddle_tpu_torch.testing.dist_worker``, job
``ps``: two pserver shards and two sync trainers, the embedding a sparse
table looked up by the batch's ids) is held against the same algorithm in
one process on the global batch.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.distributed import ps as jps  # noqa: E402
from paddle_tpu import native as jnative  # noqa: E402

from paddle_tpu_torch import native, nn  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.distributed import ps  # noqa: E402
from paddle_tpu_torch.optimizer import SGD  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

TOL = 2e-5


@pytest.fixture
def server():
    s = native.PsServer()
    yield s
    s.stop()


@pytest.fixture
def client(server):
    c = native.PsClient("127.0.0.1", server.port)
    yield c
    c.close()


def test_dense_table_semantics(server, client):
    v = np.arange(10, dtype=np.float32)
    client.dense_init("w", v, 10, optimizer="sgd", lr=0.1)
    out, ver = client.dense_pull("w", 10)
    np.testing.assert_array_equal(out, v)
    assert ver == 0
    client.dense_init("a", np.zeros(3, np.float32), 3, optimizer="adam",
                      lr=0.1)
    g = np.array([1.0, -1.0, 0.5], np.float32)
    client.dense_push("a", g)
    np.testing.assert_allclose(client.dense_pull("a", 3)[0],
                               -0.1 * np.sign(g), rtol=1e-4, atol=1e-5)
    c2 = native.PsClient("127.0.0.1", server.port)
    try:
        for c in (client, c2):
            c.dense_init("s", np.zeros(2, np.float32), 2, optimizer="sgd",
                         lr=1.0, sync_world=2)
        assert client.dense_push("s", np.array([2.0, 0.0],
                                               np.float32)) == 0
        assert c2.dense_push("s", np.array([0.0, 4.0], np.float32)) == 1
        out, ver = client.dense_pull("s", 2, min_version=1)
        np.testing.assert_allclose(out, [-1.0, -2.0])
    finally:
        c2.close()
    with pytest.raises(TimeoutError):
        client.dense_pull("s", 2, min_version=5, timeout_ms=100)


def test_save_load_keeps_the_optimizer_state(client, tmp_path):
    g = np.full(4, 2.0, np.float32)
    client.dense_init("ref", np.zeros(4, np.float32), 4,
                      optimizer="adagrad", lr=0.5)
    for _ in range(3):
        client.dense_push("ref", g)
    expect, _ = client.dense_pull("ref", 4)
    client.dense_init("w", np.zeros(4, np.float32), 4, optimizer="adagrad",
                      lr=0.5)
    client.dense_push("w", g)
    path = str(tmp_path / "ps.bin")
    client.save(path)
    client.dense_push("w", g)
    client.load(path)
    client.dense_push("w", g)
    client.dense_push("w", g)
    np.testing.assert_allclose(client.dense_pull("w", 4)[0], expect,
                               rtol=1e-6)


def test_sparse_rows_are_the_jax_bindings_rows(server, client):
    """The same lazy per-id rows through either package's binding (one
    library source), and a push merged per id."""
    client.sparse_init("emb", 4, init_scale=0.1)
    ids = np.array([42, 7, 42])
    a = client.sparse_pull("emb", ids, 4)
    with jnative.PsServer() as js:
        jc = jnative.PsClient("127.0.0.1", js.port)
        jc.sparse_init("emb", 4, init_scale=0.1)
        np.testing.assert_array_equal(a, jc.sparse_pull("emb", ids, 4))
        jc.close()
    assert client.sparse_size("emb") == 2 and np.all(np.abs(a) <= 0.1)
    cluster = ps.PSCluster([f"127.0.0.1:{server.port}"])
    emb = ps.SparseEmbeddingPS(cluster, "e", 2, optimizer="adagrad", lr=0.5,
                               init_scale=0.0)
    emb.push(np.array([7, 7]), np.ones((2, 2), np.float32))
    np.testing.assert_allclose(emb.pull(np.array([7])), -0.5, rtol=1e-5)
    cluster.close()


def test_block_split_and_the_dense_adapter_match_jax():
    for size, n in ((100000, 3), (50, 2), (20000, 2)):
        assert ps._split_blocks("w", size, n) == jps._split_blocks("w", size,
                                                                   n)
    s1, s2 = native.PsServer(), native.PsServer()
    try:
        cluster = ps.PSCluster([f"127.0.0.1:{s1.port}",
                                f"127.0.0.1:{s2.port}"])
        params = {"a": np.arange(50000, dtype=np.float32),
                  "b": np.ones((3, 3), np.float32)}
        ad = ps.DensePSAdapter(cluster, params, optimizer="sgd", lr=1.0)
        out = ad.pull()
        np.testing.assert_array_equal(out["a"], params["a"])
        ad.push({"a": np.ones(50000, np.float32),
                 "b": np.zeros((3, 3), np.float32)})
        out = ad.pull()
        np.testing.assert_allclose(out["a"], params["a"] - 1.0)
        np.testing.assert_array_equal(out["b"], params["b"])
        cluster.close()
    finally:
        s1.stop()
        s2.stop()


class _JaxReg(jpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jpt.nn.Linear(4, 1)

    def forward(self, x):
        return self.fc(x)


class _Reg(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(4, 1, device="cpu")

    def forward(self, x):
        return self.fc(x)


def _data(n=256):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    w_true = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    return x, x @ w_true + 0.7


def _run(pkg, mode, steps=24):
    """(losses, params) of ``pkg``'s PSTrainStep on the mirror's data."""
    nat = jnative if pkg is jps else native
    jpt.seed(0)
    jm = _JaxReg()
    s = nat.PsServer()
    try:
        cluster = pkg.PSCluster([f"127.0.0.1:{s.port}"])
        if pkg is jps:
            model = jm
            local = jpt.optimizer.SGD(learning_rate=0.1)
        else:
            model = _Reg()
            load_jax_params(model, {k: np.asarray(v)
                                    for k, v in jm.param_dict().items()})
            local = SGD(0.1)
        step = pkg.PSTrainStep(model, lambda o, y: ((o - y) ** 2).mean(),
                               cluster, mode=mode, n_trainers=1,
                               optimizer="sgd", lr=0.1, geo_k=4,
                               local_optimizer=local)
        x, y = _data()
        losses = []
        for i in range(steps):
            b = slice((i * 32) % 256, (i * 32) % 256 + 32)
            losses.append(step(x[b], labels=(y[b],))["loss"])
        params = {k: np.asarray(v) for k, v in step.params.items()}
        cluster.close()
    finally:
        s.stop()
    return np.asarray(losses), params


@pytest.mark.parametrize("mode", ["sync", "async", "geo"])
def test_ps_train_step_matches_jax(mode):
    want_l, want_p = _run(jps, mode)
    got_l, got_p = _run(ps, mode)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=1e-6)
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k], v, rtol=TOL,
                                   atol=TOL * np.abs(v).max(), err_msg=k)
    assert got_l[-1] < 0.05 * got_l[0]


def test_heartbeat_monitor_detects_a_silent_worker():
    with native.PsServer() as server:
        cli = native.PsClient(port=server.port)
        try:
            mon = ps.HeartbeatMonitor(cli, interval_s=0.1)
            with mon:
                mon.start_beating("w0")
                time.sleep(0.4)
                assert mon.dead_workers(["w0"], timeout_ms=1000) == []
                assert mon.dead_workers(["w0", "w1"],
                                        timeout_ms=1000) == ["w1"]
            time.sleep(0.5)
            assert mon.dead_workers(["w0"], timeout_ms=300) == ["w0"]
            assert mon.dead_workers(["w0"], timeout_ms=60000) == []
            mon.start_beating("w0")  # restartable
            time.sleep(0.3)
            assert mon.dead_workers(["w0"], timeout_ms=250) == []
            mon.stop()
        finally:
            cli.close()


def test_run_server_stops_on_its_event():
    stop = threading.Event()
    got = []
    t = threading.Thread(target=ps.run_server, kwargs=dict(
        ready_callback=got.append, stop_event=stop))
    t.start()
    deadline = time.monotonic() + 10
    while not got and time.monotonic() < deadline:
        time.sleep(0.01)
    cli = native.PsClient(port=got[0].port)
    cli.dense_init("w", np.ones(2, np.float32), 2)
    cli.close()
    stop.set()
    t.join(10)
    assert not t.is_alive() and got[0]._h == -1


# -- two pserver shards, two sync trainers ------------------------------------

def _ps_inputs():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 16, (W.PS_STEPS, 8, 2)).astype(np.int64)
    w = rng.standard_normal((16, 1)).astype(np.float32)
    y = (w[ids[..., 0]] - w[ids[..., 1]]).astype(np.float32)
    return {"ps_ids": ids, "ps_y": y,
            "psreg/0.weight": rng.standard_normal((16, 4)).astype(
                np.float32),
            "psreg/2.weight": rng.standard_normal((8, 1)).astype(
                np.float32) * 0.3,
            "psreg/2.bias": np.zeros(1, np.float32)}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = _ps_inputs()
    outs = W.run_job("ps", tmp_path_factory.mktemp("ps"), 4, inputs,
                     timeout_s=240)
    return inputs, outs


def test_two_sync_trainers_over_two_shards_match_one_process(job):
    """Each trainer's half of the batch, the shards averaging the dense
    gradients and the sparse rows taking each trainer's share: the same
    parameters as one trainer on the whole batch."""
    import torch
    inputs, outs = job
    trainers = [o for o in outs if str(o["role"]) == "trainer"]
    assert len(trainers) == 2 and [str(o["role"]) for o in outs[:2]] == [
        "server", "server"]
    s1, s2 = native.PsServer(), native.PsServer()
    try:
        cluster = ps.PSCluster([f"127.0.0.1:{s1.port}",
                                f"127.0.0.1:{s2.port}"])
        model = nn.Sequential(nn.Embedding(16, 4, device="cpu"),
                              nn.Flatten(), nn.Linear(8, 1, device="cpu"))
        load_jax_params(model, {k[6:]: v for k, v in inputs.items()
                                if k.startswith("psreg/")})
        emb = ps.SparseEmbeddingPS(cluster, "emb", 4, optimizer="sgd",
                                   lr=W.PS_LR, init_scale=0.05)
        step = ps.PSTrainStep(model, lambda o, t: ((o - t) ** 2).mean(),
                              cluster, mode="sync", n_trainers=1,
                              optimizer="sgd", lr=W.PS_LR,
                              sparse_tables={"0.weight": (emb, 0)})
        losses = [step(torch.tensor(inputs["ps_ids"][i]),
                       labels=(torch.tensor(inputs["ps_y"][i]),))["loss"]
                  for i in range(W.PS_STEPS)]
        want_emb = emb.pull(np.arange(16))
        want = step.params
        cluster.close()
    finally:
        s1.stop()
        s2.stop()
    np.testing.assert_allclose(
        np.mean([o["loss"] for o in trainers], axis=0), losses, rtol=1e-5)
    for o in trainers:
        np.testing.assert_allclose(o["emb"], want_emb, rtol=TOL, atol=1e-6)
        for k, v in want.items():
            np.testing.assert_allclose(o[f"param/{k}"], v, rtol=TOL,
                                       atol=1e-6, err_msg=k)
    assert losses[-1] < losses[0]


class _TiedReader(nn.Layer):
    """An embedding whose whole table is read again (a tied decoder)."""

    def __init__(self) -> None:
        super().__init__()
        self.emb = nn.Embedding(16, 4, device="cpu")

    def forward(self, ids):
        return self.emb(ids).sum() + self.emb.weight.sum()


def test_sparse_table_serves_the_ids_rows_alone(server):
    """Only the rows of the batch's ids are pulled into the parameter and
    pushed; a model that reads any other row of it raises."""
    import torch
    cluster = ps.PSCluster([f"127.0.0.1:{server.port}"])
    try:
        model = nn.Sequential(nn.Embedding(16, 4, device="cpu"),
                              nn.Flatten(), nn.Linear(8, 1, device="cpu"))
        before = model[0].weight.detach().clone()
        emb = ps.SparseEmbeddingPS(cluster, "e", 4, optimizer="sgd",
                                   lr=0.1, init_scale=0.05)
        step = ps.PSTrainStep(model, lambda o, t: ((o - t) ** 2).mean(),
                              cluster, mode="sync", n_trainers=1,
                              optimizer="sgd", lr=0.1,
                              sparse_tables={"0.weight": (emb, 0)})
        ids = torch.tensor([[3, 5], [5, 9]])
        step(ids, labels=(torch.ones(2, 1),))
        assert emb.size() == 3  # rows 3, 5, 9 alone exist on the server
        rest = [i for i in range(16) if i not in (3, 5, 9)]
        np.testing.assert_array_equal(model[0].weight[rest].detach(),
                                      before[rest])
        emb2 = ps.SparseEmbeddingPS(cluster, "e2", 4)
        tied = ps.PSTrainStep(_TiedReader(), lambda o: o, cluster,
                              mode="async", optimizer="sgd",
                              sparse_tables={"emb.weight": (emb2, 0)})
        with pytest.raises(ValueError, match="read outside the ids"):
            tied(torch.tensor([1, 2]))
    finally:
        cluster.close()
