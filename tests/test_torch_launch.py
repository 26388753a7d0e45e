"""PyTorch port: the launcher (``distributed.launch``), the control plane's
bindings (``native.ControlPlaneServer``/``Client``) and
``InMemoryDataset.global_shuffle`` over two ranks, against the JAX
package.

The launcher tests start real processes (plain Python scripts, no torch,
each gang bounded by ``timeout_s``); ``global_shuffle`` runs as the
``gshuffle`` job of ``paddle_tpu_torch.testing.dist_worker`` on two ranks
behind the port's ``launch_procs``, and the JAX side as two threads of
this process against a JAX control plane: the same files and seeds give
each rank the same records in the same order.
"""

import os
import sys
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
from paddle_tpu import data as jdata  # noqa: E402
from paddle_tpu import native as jnative  # noqa: E402
from paddle_tpu.distributed import launch as jlaunch  # noqa: E402

from paddle_tpu_torch import native as pnative  # noqa: E402
from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch.distributed import launch as plaunch  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

GANG_TIMEOUT_S = 60.0


@pytest.mark.parametrize("code", [0, 1, 3, -15, 143, -9, 137])
def test_classify_exit_matches_jax(code):
    assert plaunch.classify_exit(code) == jlaunch.classify_exit(code)


def test_cluster_and_fleet_env_match_jax(monkeypatch):
    assert plaunch.get_cluster_env(2, 4, "127.0.0.1:9") == \
        jlaunch.get_cluster_env(2, 4, "127.0.0.1:9")
    for base in ("", "0", "-1", "7100", "junk"):
        env = {"FLAGS_metrics_port": base} if base else {}
        assert plaunch.fleet_observability_env(3, env) == \
            jlaunch.fleet_observability_env(3, env)
    # the per-rank exporter port and the fleet reporter's discovery env
    got = plaunch.fleet_observability_env(1, {"FLAGS_metrics_port": "7100"})
    assert got["FLAGS_metrics_port"] == "7101"
    assert got["PT_FLEET_AGGREGATOR"] == "127.0.0.1:7100"
    from paddle_tpu_torch.observability import fleet
    assert (fleet.AGGREGATOR_ENV, fleet.HOST_ENV) == (
        "PT_FLEET_AGGREGATOR", "PT_FLEET_HOST")
    monkeypatch.setenv("PT_FLEET_HOST", got["PT_FLEET_HOST"])
    assert fleet.default_host_id() == got["PT_FLEET_HOST"]


def test_control_plane_set_get_add_barrier():
    with pnative.ControlPlaneServer() as srv:
        with pnative.ControlPlaneClient(port=srv.port) as a, \
                pnative.ControlPlaneClient(port=srv.port) as b:
            a.set("k", b"\x00value")
            assert b.get("k") == b"\x00value"
            with pytest.raises(KeyError):
                b.get("missing", block=False)
            with pytest.raises(TimeoutError):
                b.get("missing", block=True, timeout_ms=50)
            assert a.add("n", 2) == 2 and b.add("n", 3) == 5
            big = bytes(range(256)) * 8192  # past the first buffer
            a.set("big", big)
            assert b.get("big") == big
            seen = []
            t = threading.Thread(target=lambda: (a.barrier("x", 2, 5000),
                                                 seen.append(1)))
            t.start()
            b.barrier("x", 2, 5000)
            t.join(5)
            assert seen == [1]
            with pytest.raises(TimeoutError):
                a.barrier("lonely", 2, 50)
    # the JAX client reads what the port's server holds (one protocol)
    with pnative.ControlPlaneServer() as srv:
        with pnative.ControlPlaneClient(port=srv.port) as a, \
                jnative.ControlPlaneClient(port=srv.port) as j:
            a.set("shared", b"abc")
            assert j.get("shared") == b"abc"


def _script(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(body)
    return str(p)


def test_launch_two_ranks_rendezvous_at_the_control_plane(tmp_path):
    out = tmp_path / "out"
    script = _script(tmp_path, "worker.py", f"""
import os, sys
sys.path.insert(0, {os.getcwd()!r})
from paddle_tpu_torch import native
rank = int(os.environ["PT_TRAINER_ID"])
world = int(os.environ["PT_TRAINERS_NUM"])
host, port = os.environ["PT_CP_ENDPOINT"].split(":")
c = native.ControlPlaneClient(host, int(port))
c.set(f"hello/{{rank}}", str(rank).encode())
c.barrier("ready", world, 20000)
peers = sorted(int(c.get(f"hello/{{r}}")) for r in range(world))
assert peers == list(range(world)), peers
assert os.environ["LOCAL_WORLD_SIZE"] == str(world)
assert os.environ["PT_STORE_PATH"]
with open(r"{out}" + f"-{{rank}}", "w") as fh:
    fh.write("ok")
""")
    assert plaunch.launch_procs([sys.executable, script], nproc=2,
                                timeout_s=GANG_TIMEOUT_S) == 0
    for r in range(2):
        assert (tmp_path / f"out-{r}").read_text() == "ok"


def test_a_failed_child_tears_the_gang_down(tmp_path):
    script = _script(tmp_path, "boom.py", """
import os, sys, time
if os.environ["PT_TRAINER_ID"] == "1":
    sys.exit(3)
time.sleep(60)  # torn down by the launcher, not by its own end
""")
    import time
    t0 = time.monotonic()
    rc = plaunch.launch_procs([sys.executable, script], nproc=2,
                              start_control_plane=False,
                              timeout_s=GANG_TIMEOUT_S)
    assert rc == 3 and time.monotonic() - t0 < 30
    hang = _script(tmp_path, "hang.py", "import time; time.sleep(60)\n")
    assert plaunch.launch_procs([sys.executable, hang], nproc=1,
                                start_control_plane=False,
                                timeout_s=1.0) == 124


def _counter(name):
    snap = obs.registry().snapshot()
    return {tuple(sorted(s["labels"].items())): s["value"]
            for s in snap.get(name, {}).get("series", [])}


def test_launch_elastic_restarts_and_keeps_to_its_budget(tmp_path):
    marker = tmp_path / "attempts"
    flaky = _script(tmp_path, "flaky.py", f"""
import os, sys
attempt = int(os.environ["PT_ELASTIC_ATTEMPT"])
if os.environ["PT_TRAINER_ID"] == "1":
    with open(r"{marker}", "a") as f:
        f.write(str(attempt))
    if attempt == 0:
        sys.exit(3)
""")
    obs.reset_all()
    try:
        assert plaunch.launch_elastic([sys.executable, flaky], nproc=2,
                                      max_restarts=3, poll_interval=0.05,
                                      start_control_plane=False) == 0
        assert marker.read_text() == "01"
        assert _counter("elastic_restarts_total") == {
            (("kind", "crash"),): 1}
        # a crash loop: more than 1 crash in the window gives up early
        crash = _script(tmp_path, "crash.py", "import sys; sys.exit(5)\n")
        assert plaunch.launch_elastic([sys.executable, crash], nproc=1,
                                      max_restarts=10, poll_interval=0.05,
                                      restart_budget=1,
                                      start_control_plane=False) == 5
        assert _counter("elastic_budget_exhausted_total") == {(): 1}
        assert _counter("elastic_restarts_total") == {
            (("kind", "crash"),): 3}
    finally:
        obs.reset_all()


def test_spawn_runs_the_function_in_each_rank(tmp_path):
    codes = plaunch.spawn(W.spawn_probe, (str(tmp_path),), nprocs=2,
                          timeout=GANG_TIMEOUT_S)
    assert codes == [0, 0]
    for r in range(2):
        env = dict(line.split("=", 1) for line in
                   (tmp_path / f"spawn-{r}").read_text().splitlines())
        assert env["PT_TRAINER_ID"] == str(r)
        assert env["PT_TRAINERS_NUM"] == "2"
        assert env["PT_CP_ENDPOINT"].startswith("127.0.0.1:")
        assert env["PT_STORE_PATH"] and env["LOCAL_WORLD_SIZE"] == "2"


def _write_slot_files(d):
    files = []
    for part in range(2):
        rng = np.random.default_rng(part)
        lines = []
        for _ in range(10 + 3 * part):
            n = int(rng.integers(1, 13))
            feat = " ".join(f"{v:.4f}" for v in rng.standard_normal(6))
            src = " ".join(str(int(v)) for v in rng.integers(3, 500, n))
            tgt = " ".join(str(int(v)) for v in rng.integers(3, 500, 9))
            lines.append(f"6 {feat} {n} {src} 9 {tgt}\n")
        p = d / f"part-{part}"
        p.write_text("".join(lines))
        files.append(str(p))
    return files


def test_global_shuffle_over_two_ranks_matches_jax(tmp_path):
    files = _write_slot_files(tmp_path)
    outs = W.run_job("gshuffle", tmp_path / "job", 2,
                     {"files": np.asarray(files)}, timeout_s=GANG_TIMEOUT_S)
    want = [None, None]
    errors = []
    with jnative.ControlPlaneServer() as srv:
        def rank_body(rank):
            try:
                ds = jdata.DatasetFactory().create_dataset("InMemoryDataset")
                ds.set_slots(W.GSHUFFLE_SLOTS)
                ds.set_batch_size(4)
                ds.set_thread(1)
                ds.set_filelist([files[rank]])
                ds.load_into_memory()
                with jnative.ControlPlaneClient(port=srv.port) as cli:
                    n = ds.global_shuffle(cli, rank, 2)
                want[rank] = (n, list(ds))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=rank_body, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(GANG_TIMEOUT_S)
    assert not errors, errors
    assert sum(int(o["count"]) for o in outs) == 23
    for r, out in enumerate(outs):
        n, batches = want[r]
        assert int(out["count"]) == n
        assert len(batches) == len({k.split("/")[0] for k in out
                                    if k.startswith("batch")})
        for i, b in enumerate(batches):
            for k, v in b.items():
                np.testing.assert_array_equal(out[f"batch{i}/{k}"], v)
