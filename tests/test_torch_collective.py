"""PyTorch port: ``parallel.collective`` against the JAX collectives.

The port runs in four Gloo processes (``paddle_tpu_torch.testing.
dist_worker``, job ``collective``, one job for the module); the JAX side
runs each op inside ``shard_map`` over four of the conftest's eight
virtual CPU devices (``create_mesh({"dp": 4}, allow_submesh=True)``). Rank
r of the port holds block r of the global input, as shard r of the JAX
array. Gradients: the port's rank r gets d(sum over ranks of each rank's
loss)/d(its block), as ``jax.grad`` of the summed shard_map gives it for
shard r. fp32, every op exact up to 1e-6 relative (sums of four values
in another order).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from paddle_tpu.parallel import collective as JC  # noqa: E402
from paddle_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from paddle_tpu.parallel._shard_map import shard_map  # noqa: E402

from paddle_tpu_torch import observability as obs  # noqa: E402
from paddle_tpu_torch import set_flags  # noqa: E402
from paddle_tpu_torch.parallel import collective as C  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

WORLD = 4
TOL = 1e-6


def _inputs():
    rng = np.random.default_rng(0)
    return dict(x=rng.standard_normal((WORLD, 8, 12)).astype(np.float32),
                pos=(rng.random((WORLD, 8, 12)) + 0.5).astype(np.float32),
                w_gather=rng.standard_normal((32, 12)).astype(np.float32),
                w_scatter=rng.standard_normal((WORLD, 8, 3)).astype(
                    np.float32),
                w_a2a=rng.standard_normal((WORLD, 2, 48)).astype(
                    np.float32),
                w_perm=rng.standard_normal((WORLD, 8, 12)).astype(
                    np.float32))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = _inputs()
    outs = W.run_job("collective", tmp_path_factory.mktemp("coll"), WORLD,
                     inputs, timeout_s=120)
    return inputs, outs


def _per_rank(fn, *arrays):
    """fn inside shard_map over dp 4: each rank's output, stacked."""
    mesh = jax_mesh({"dp": WORLD}, allow_submesh=True)
    JC.new_group("dp", ring_id=0)

    def body(*xs):
        return fn(*xs)[None]

    specs = tuple(JP("dp") for _ in arrays)
    glob = [jnp.asarray(a.reshape((-1,) + a.shape[2:])) for a in arrays]
    out = shard_map(body, mesh=mesh, in_specs=specs, out_specs=JP("dp"),
                    check_vma=False)(*glob)
    return np.asarray(out)


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want).max()))


OPS = {
    "all_reduce_sum": (lambda x: JC.all_reduce(x, "sum", "dp"), "x"),
    "all_reduce_mean": (lambda x: JC.all_reduce(x, "mean", "dp"), "x"),
    "all_reduce_max": (lambda x: JC.all_reduce(x, "max", "dp"), "x"),
    "all_reduce_min": (lambda x: JC.all_reduce(x, "min", "dp"), "x"),
    "all_reduce_prod": (lambda x: JC.all_reduce(x, "prod", "dp"), "pos"),
    "reduce": (lambda x: JC.reduce(x, 0, "sum", "dp"), "x"),
    "all_gather_0": (lambda x: JC.all_gather(x, 0, "dp"), "x"),
    "all_gather_1": (lambda x: JC.all_gather(x, 1, "dp"), "x"),
    "reduce_scatter_0": (lambda x: JC.reduce_scatter(x, 0, "dp"), "x"),
    "reduce_scatter_1": (lambda x: JC.reduce_scatter(x, 1, "dp"), "x"),
    "broadcast": (lambda x: JC.broadcast(x, 1, "dp"), "x"),
    "scatter": (lambda x: JC.scatter(x, 2, "dp"), "x"),
    "all_to_all": (lambda x: JC.all_to_all(x, 0, 1, "dp"), "x"),
    "ppermute": (lambda x: JC.ppermute(
        x, [(i, (i + 1) % WORLD) for i in range(WORLD)], "dp"), "x"),
    "ppermute_partial": (lambda x: JC.ppermute(x, [(0, 2), (1, 3)], "dp"),
                         "x"),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_collective_matches_jax_shard_map(job, op):
    inputs, outs = job
    fn, src = OPS[op]
    want = _per_rank(fn, inputs[src])
    for r, out in enumerate(outs):
        _close(out[op], want[r])


RING = [(i, (i + 1) % WORLD) for i in range(WORLD)]
GRADS = {
    "all_gather": (lambda x, w: jnp.sum(JC.all_gather(x, 0, "dp") * w[0]),
                   "w_gather"),
    "reduce_scatter": (lambda x, w: jnp.sum(JC.reduce_scatter(x, 1, "dp")
                                            * w[0]), "w_scatter"),
    "all_to_all": (lambda x, w: jnp.sum(JC.all_to_all(x, 0, 1, "dp")
                                        * w[0]), "w_a2a"),
    "ppermute": (lambda x, w: jnp.sum(JC.ppermute(x, RING, "dp") * w[0]),
                 "w_perm"),
    "all_reduce": (lambda x, w: jnp.sum(JC.all_reduce(x, "sum", "dp")
                                        * w[0]), "w_perm"),
}


@pytest.mark.parametrize("op", sorted(GRADS))
def test_collective_gradient_matches_jax(job, op):
    inputs, outs = job
    fn, wname = GRADS[op]
    mesh = jax_mesh({"dp": WORLD}, allow_submesh=True)
    w = inputs[wname]
    if w.shape[0] != WORLD:  # one weight for every rank
        w = np.broadcast_to(w, (WORLD,) + w.shape)
    wg = jnp.asarray(w.reshape((-1,) + w.shape[2:]))

    def total(xg):
        per = shard_map(lambda x, ww: fn(x, ww[None])[None], mesh=mesh,
                        in_specs=(JP("dp"), JP("dp")), out_specs=JP("dp"),
                        check_vma=False)(xg, wg)
        return jnp.sum(per)

    xg = jnp.asarray(inputs["x"].reshape(-1, 12))
    want = np.asarray(jax.grad(total)(xg)).reshape(WORLD, 8, 12)
    for r, out in enumerate(outs):
        _close(out[f"grad_{op}"], want[r])


def test_group_registry_mesh_axes_and_counters(job):
    inputs, outs = job
    x = inputs["x"]
    for r, out in enumerate(outs):
        assert int(out["rank"]) == r and int(out["world_size"]) == WORLD
        # mesh {"dp": 2, "mp": 2}: ranks (2d, 2d + 1) share an mp line
        mate = r ^ 1
        _close(out["mp_sum"], x[r].astype(np.float64) + x[mate])
        _close(out["mp_sum_ring7"], out["mp_sum"])
        # one count per call, the bytes handed over
        calls = dict(zip(out["calls_ops"].tolist(),
                         out["calls_n"].tolist()))
        assert calls == {"all_reduce": 6, "all_gather": 2,
                         "reduce_scatter": 2, "broadcast": 1,
                         "scatter": 1, "all_to_all": 1, "ppermute": 2}
        assert int(out["bytes_all_gather"]) == 2 * x[r].nbytes


def test_single_process_meaning_is_the_identity():
    import torch.distributed as dist
    assert not dist.is_initialized()
    x = torch.arange(6.0).reshape(2, 3)
    set_flags({"enable_metrics": True})
    obs.reset_all()
    try:
        for out in (C.all_reduce(x, "sum"), C.all_gather(x, 1),
                    C.reduce_scatter(x), C.broadcast(x, 3),
                    C.scatter(x), C.all_to_all(x, 0, 1),
                    C.ppermute(x, [(0, 1)]), C.reduce(x)):
            assert out is x
        assert int(C.rank()) == 0 and C.world_size() == 1
        assert float(C.barrier()) == 1.0
        # the identity launches nothing and counts nothing, as JAX
        assert "collective_calls_total" not in obs.registry().snapshot() \
            or not obs.registry().snapshot()[
                "collective_calls_total"]["series"]
    finally:
        set_flags({"enable_metrics": False})
        obs.reset_all()
    # outside a group even an unknown op is the identity, as in JAX
    assert C.all_reduce(x, "median") is x
    assert JC.all_reduce(jnp.ones(2), "median") is not None
    g = C.new_group(("dp", "mp"), ring_id=11)
    assert C.get_group(11) is g and g.axis == ("dp", "mp")
    assert C.get_group(0).axis == "dp"
    # JAX's registry makes the same default
    assert JC.get_group(0).axis == "dp"
