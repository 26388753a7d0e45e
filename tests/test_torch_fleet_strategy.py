"""PyTorch port: ``distributed.fleet`` (``DistributedStrategy``, ``Fleet``,
``distributed_optimizer``), the strategy compiler (``apply_strategy``'s
routes and ``_ComposedTrainStep``: gradient merge, recompute, ZeRO 3,
tensor parallelism, the hierarchical all-reduce's mesh) and
``fleet.metrics`` against the JAX package.

The port runs in four Gloo processes (``paddle_tpu_torch.testing.
dist_worker``, job ``fleet``; each composed case is
``dist_worker.FLEET_CASES``), every rank called with the global batch and
building its mesh from the strategy as the JAX compiler does; the JAX
steps run over four of the conftest's eight virtual CPU devices (the same
layout passed as the mesh). The metrics run over the launcher's control
plane, each rank with its own statistics, against the JAX functions on
the summed statistics. Tolerance ``TOL`` (relative to a tensor's largest
entry) for losses and every parameter over 3 Adam steps in fp32; 1e-12
for the metrics (float64 sums of a few numbers).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.distributed import fleet as jfleet  # noqa: E402
from paddle_tpu.ops import loss as JL  # noqa: E402
from paddle_tpu.parallel import create_mesh as jax_mesh  # noqa: E402

from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

WORLD = 4
TOL = 2e-5


class JaxMLP(jpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jpt.nn.Linear(16, 64)
        self.act = jpt.nn.GELU()
        self.fc2 = jpt.nn.Linear(64, 4)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


def _jax_mlp():
    jpt.seed(0)
    return JaxMLP()


def _inputs():
    rng = np.random.default_rng(0)
    inputs = dict(x=rng.standard_normal((16, 16)).astype(np.float32),
                  y=rng.integers(0, 4, 16).astype(np.int64))
    for k, v in _jax_mlp().param_dict().items():
        inputs[f"mlp/{k}"] = np.asarray(v)
    correct = rng.integers(0, 5, WORLD).astype(np.float64)
    total = correct + rng.integers(1, 5, WORLD)
    inputs["metric_stats"] = np.stack(
        [correct, total, rng.random(WORLD) * 3, rng.random(WORLD) * 5], 1)
    inputs["auc_pos"] = rng.integers(0, 9, (WORLD, 6)).astype(np.float64)
    inputs["auc_neg"] = rng.integers(0, 9, (WORLD, 6)).astype(np.float64)
    return inputs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = _inputs()
    outs = W.run_job("fleet", tmp_path_factory.mktemp("fleet"), WORLD,
                     inputs, timeout_s=240)
    return inputs, outs


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1e-3, np.abs(want).max()),
                               err_msg=what)


# the port's mesh from the strategy at world 4, and the JAX mesh it
# mirrors
_MESH = {"tp": {"dp": 2, "mp": 2}, "hier": {"dcn": 1, "dp": 4}}


@pytest.mark.parametrize("case", sorted(W.FLEET_CASES))
def test_composed_strategy_matches_jax(job, case):
    inputs, outs = job
    spec = W.FLEET_CASES[case]
    axes = _MESH.get(case, {"dp": WORLD})
    s = W.fleet_strategy(jfleet, spec)
    opt = jfleet.distributed_optimizer(jpt.optimizer.Adam(1e-2), s)
    step = jfleet.apply_strategy(s, _jax_mlp(), opt,
                                 lambda o, t: JL.cross_entropy(o, t),
                                 mesh=jax_mesh(axes, allow_submesh=True))
    losses = [float(step(inputs["x"], labels=(inputs["y"],))["loss"])
              for _ in range(W.FLEET_STEPS)]
    for r, out in enumerate(outs):
        assert str(out[f"{case}/type"]) == "_ComposedTrainStep"
        assert out[f"{case}/mesh"].tolist() == [f"{k}={v}" for k, v in
                                                axes.items()]
        _close(out[f"{case}/loss"], losses, TOL, f"{case} loss r{r}")
        for n, v in step.state["params"].items():
            _close(out[f"{case}/param/{n}"], np.asarray(v), TOL,
                   f"{case} {n} r{r}")


def test_apply_strategy_routes_as_jax(job):
    """The JAX suite's routing cases (tests/test_fleet_advanced.py
    TestStrategyCompilerRouting), and amp with dgc refused."""
    _, outs = job
    for out in outs:
        assert bool(out["route/dgc"]) and bool(out["route/localsgd"]) \
            and bool(out["route/sharding"])
        assert "does not compose with dgc/localsgd" in str(
            out["route/amp_dgc"])
        assert out["fleet/worker"].tolist()[1:] == [WORLD, int(
            out["fleet/worker"][0] == 0)]


def test_fleet_metrics_aggregate_across_ranks(job):
    inputs, outs = job
    st = inputs["metric_stats"].sum(0)
    pos, neg = inputs["auc_pos"].sum(0), inputs["auc_neg"].sum(0)
    want = [float(sum(range(1, WORLD + 1))), (WORLD - 1) * 10.0, -1.0,
            jfleet.metrics.acc(st[0], st[1]),
            jfleet.metrics.mae(st[2], st[1]),
            jfleet.metrics.mse(st[3], st[1]),
            jfleet.metrics.rmse(st[3], st[1]),
            jfleet.metrics.auc(pos, neg)]
    for out in outs:
        np.testing.assert_allclose(out["metrics/values"], want, rtol=1e-12)


def test_metrics_single_process_identity_and_auc_as_jax():
    """``tests/test_fleet_metrics.py``'s in-process cases."""
    m, jm = fleet.metrics, jfleet.metrics
    assert float(m.sum(3.0)) == float(jm.sum(3.0)) == 3.0
    assert m.acc(correct=8, total=10) == pytest.approx(0.8)
    assert m.rmse(sqrerr=4.0, total_ins_num=1) == pytest.approx(2.0)
    for pos, neg in (([0.0, 10.0], [10.0, 0.0]), ([5.0, 5.0], [5.0, 5.0]),
                     ([1.0, 2.0, 7.0], [4.0, 3.0, 1.0])):
        assert m.auc(pos, neg) == jm.auc(np.asarray(pos), np.asarray(neg))


def test_strategy_and_fleet_surface_match_jax():
    s, js = fleet.DistributedStrategy(), jfleet.DistributedStrategy()
    assert set(s.to_dict()) == set(js.to_dict())
    for k, v in js.to_dict().items():
        if not k.endswith("_configs"):
            assert s.to_dict()[k] == v, k
        elif hasattr(v, "__dict__"):
            assert vars(s.to_dict()[k]) == vars(v), k
    f = fleet.Fleet()
    assert f.worker_index() == 0 and f.worker_num() == 1
    f.init(role_maker=fleet.UserDefinedRoleMaker(current_id=0, workers=1))
    assert f.is_first_worker()
    from paddle_tpu_torch.optimizer import SGD
    opt = f.distributed_optimizer(SGD(0.1), s)
    assert opt._fleet_strategy is s and f.strategy is s
