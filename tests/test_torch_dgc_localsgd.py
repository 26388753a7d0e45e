"""PyTorch port: ``parallel.localsgd`` (``LocalSGDStep``,
``averaged_params``, ``replica_divergence``) and ``parallel.dgc``
(``topk_sparsify``, ``dgc_allreduce``, ``dgc_momentum_exchange``,
``DGCTrainStep``) against the JAX package.

The port runs in four Gloo processes (``paddle_tpu_torch.testing.
dist_worker``, job ``dgc_localsgd``), one replica a rank, each called with
the global batch; the JAX steps run over four of the conftest's eight
virtual CPU devices with the same weights and batches (the cases mirror
``tests/test_fleet_advanced.py``'s ``TestLocalSGD`` and ``TestDGC``).
Tolerance ``TOL``, relative to a tensor's largest entry, for losses,
parameters and delivered updates (fp32; sums formed in another order).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.parallel import DGCTrainStep as JaxDGC  # noqa: E402
from paddle_tpu.parallel import LocalSGDStep as JaxLocalSGD  # noqa: E402
from paddle_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from paddle_tpu.parallel import dgc_allreduce as jax_dgc_allreduce  # noqa
from paddle_tpu.parallel import topk_sparsify as jax_topk  # noqa: E402
from paddle_tpu.parallel._shard_map import shard_map  # noqa: E402

from paddle_tpu_torch.parallel import dgc as pdgc  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

WORLD = 4
TOL = 2e-5


def _data(n, din, dout, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (din, dout)).astype(np.float32)
    x = rng.normal(0, 1, (n, din)).astype(np.float32)
    y = (x @ w + 0.01 * rng.normal(0, 1, (n, dout))).astype(np.float32)
    return x, y


def _linear(din, dout, seed):
    jpt.seed(seed)
    return jpt.nn.Linear(din, dout)


def _mse(out, y):
    return jpt.nn.functional.mse_loss(out, y)


def _inputs():
    inputs = {}
    inputs["lx"], inputs["ly"] = _data(64, 8, 4, 0)
    inputs["dx"], inputs["dy"] = _data(64, 16, 4, 1)
    for prefix, (din, dout, seed) in (("lsgd/", (8, 4, 0)),
                                      ("dgc/", (16, 4, 3))):
        for k, v in _linear(din, dout, seed).param_dict().items():
            inputs[prefix + k] = np.asarray(v)
    inputs["fb_g"] = np.random.default_rng(2).normal(
        0, 1, (8, 32)).astype(np.float32)
    return inputs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = _inputs()
    outs = W.run_job("dgc_localsgd", tmp_path_factory.mktemp("dgc"), WORLD,
                     inputs, timeout_s=240)
    return inputs, outs


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1e-3, np.abs(want).max()),
                               err_msg=what)


def _mesh():
    return jax_mesh({"dp": WORLD}, allow_submesh=True)


def test_localsgd_diverges_then_resyncs_as_jax(job):
    inputs, outs = job
    step = JaxLocalSGD(_linear(8, 4, 0), jpt.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9), _mse, _mesh(),
        k_steps=W.LOCALSGD_K)
    losses, divs = [], []
    for _ in range(W.LOCALSGD_K + 1):
        losses.append(float(step(inputs["lx"], labels=(inputs["ly"],))[
            "loss"]))
        divs.append(step.replica_divergence())
    avg = step.averaged_params()
    for r, out in enumerate(outs):
        _close(out["lsgd/loss"], losses, TOL, f"loss r{r}")
        # replicas see different rows: they diverge between syncs, and
        # the k-th call averages them
        div = out["lsgd/div"]
        assert div[0] > 0 and div[W.LOCALSGD_K - 1] < 1e-6 \
            and div[W.LOCALSGD_K] > 0, div
        _close(div, divs, 1e-4, f"divergence r{r}")
        for n, v in step.state["params"].items():
            _close(out[f"lsgd/param/{n}"], np.asarray(v)[r], TOL,
                   f"{n} r{r}")
            _close(out[f"lsgd/avg/{n}"], np.asarray(avg[n]), TOL,
                   f"avg {n} r{r}")


def test_dgc_step_matches_jax_through_and_past_the_warmup(job):
    inputs, outs = job
    step = JaxDGC(_linear(16, 4, 3), jpt.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9), _mse, _mesh(), sparsity=0.75,
        rampup_steps=3)
    losses = [float(step(inputs["dx"], labels=(inputs["dy"],))["loss"])
              for _ in range(W.DGC_STEPS)]
    for r, out in enumerate(outs):
        _close(out["dgc/loss"], losses, TOL, f"loss r{r}")
        for n, v in step.params.items():
            _close(out[f"dgc/param/{n}"], np.asarray(v), TOL, f"{n} r{r}")


def test_dgc_allreduce_error_feedback_matches_jax(job):
    """Each exchange delivers what the JAX one does, and over 20 steps of
    a constant gradient the delivered updates plus the residual carry
    the whole gradient (the JAX test's property)."""
    inputs, outs = job
    g = jnp.asarray(inputs["fb_g"])

    def inner(r):
        return jax_dgc_allreduce(g, r, "dp", sparsity=0.9)

    fn = jax.jit(shard_map(inner, mesh=_mesh(), in_specs=(JP(),),
                           out_specs=(JP(), JP()), check_vma=False))
    res = jnp.zeros_like(g)
    want = []
    for _ in range(W.DGC_FEEDBACK_STEPS):
        out, res = fn(res)
        want.append(np.asarray(out))
    for r, o in enumerate(outs):
        _close(o["fb/delivered"], np.stack(want), TOL, f"delivered r{r}")
        _close(o["fb/residual"], np.asarray(res), TOL, f"residual r{r}")
        total = o["fb/delivered"].sum(0) + o["fb/residual"]
        np.testing.assert_allclose(total, inputs["fb_g"] * 20, rtol=1e-3)


def test_topk_sparsify_matches_jax():
    import torch
    g = np.array([0.1, -5.0, 0.2, 3.0, -0.05], np.float32)
    vals, idx, residual = pdgc.topk_sparsify(torch.tensor(g), 2)
    jv, ji, jr = jax_topk(jnp.asarray(g), 2)
    assert sorted(idx.tolist()) == sorted(np.asarray(ji).tolist()) == [1, 3]
    np.testing.assert_array_equal(np.sort(vals.numpy()),
                                  np.sort(np.asarray(jv)))
    np.testing.assert_array_equal(residual.numpy(), np.asarray(jr))
    rng = np.random.default_rng(5)
    g = rng.standard_normal((6, 7)).astype(np.float32)
    vals, idx, residual = pdgc.topk_sparsify(torch.tensor(g), 9)
    jv, ji, jr = jax_topk(jnp.asarray(g), 9)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(residual.numpy(), np.asarray(jr))


@pytest.mark.parametrize("use_dgc", [False, True])
def test_momentum_exchange_one_replica_matches_jax(use_dgc):
    """One process is a world of one replica (the JAX function over a
    one-device axis): the velocity, residual and delivered update."""
    import torch
    from paddle_tpu.parallel.dgc import dgc_momentum_exchange as jax_ex
    rng = np.random.default_rng(7)
    g, u, r = (rng.standard_normal((5, 8)).astype(np.float32)
               for _ in range(3))
    got = pdgc.dgc_momentum_exchange(
        torch.tensor(g), torch.tensor(u), torch.tensor(r),
        torch.tensor(use_dgc), None, 0.8, 0.9)
    mesh = jax_mesh({"dp": 1}, allow_submesh=True)
    fn = shard_map(lambda a, b, c: jax_ex(a, b, c, jnp.asarray(use_dgc),
                                          "dp", 0.8, 0.9),
                   mesh=mesh, in_specs=(JP(), JP(), JP()),
                   out_specs=(JP(), JP(), JP()), check_vma=False)
    want = fn(jnp.asarray(g), jnp.asarray(u), jnp.asarray(r))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_fused_state_is_refused():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import LocalSGDStep, create_mesh
    with pytest.raises(ValueError, match="optimizer_fused_state"):
        LocalSGDStep(nn.Linear(4, 2, device="cpu"), Adam(
            1e-2, fused_state=True), lambda o, y: o.sum(),
            create_mesh({"dp": 1}))
