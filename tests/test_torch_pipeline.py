"""PyTorch port: ``parallel.pipeline`` (``stack_stage_params``, ``gpipe``,
``GPipeTrainStep``) against the JAX package.

The port runs in four Gloo processes (``paddle_tpu_torch.testing.
dist_worker``, job ``pipeline``), one stage a rank over a ``pp`` axis of
4; the JAX side runs ``gpipe`` and ``GPipeTrainStep`` over four of the
conftest's eight virtual CPU devices, with the same weights (crossed
with ``convert``) and batches. Tolerances: ``TOL`` relative to a
tensor's largest entry, for the schedule's output and the input's
gradient, and for the losses and every parameter over 3 Adam steps
(fp32; the sums are formed in another order); ``remat_stages`` is held
to the plain step at 1e-6, as the JAX test holds it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.nn.layer import functional_call  # noqa: E402
from paddle_tpu.ops import loss as JL  # noqa: E402
from paddle_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from paddle_tpu.parallel.pipeline import (GPipeTrainStep as JaxGPipe,  # noqa
                                          gpipe as jax_gpipe,
                                          stack_stage_params as jax_stack)

from paddle_tpu_torch.parallel import pipeline as ppipe  # noqa: E402
from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

WORLD = 4
TOL = 2e-5


def _jax_parts(widths, seed):
    jpt.seed(seed)
    d_in, hid, d_out = widths
    embed = jpt.nn.Linear(d_in, hid)
    stages = [jpt.nn.Sequential(jpt.nn.Linear(hid, hid), jpt.nn.Tanh())
              for _ in range(WORLD)]
    head = jpt.nn.Linear(hid, d_out)
    return embed, stages, head


def _put(inputs, prefix, layer):
    for k, v in layer.param_dict().items():
        inputs[f"{prefix}{k}"] = np.asarray(v)


def _inputs():
    rng = np.random.default_rng(0)
    inputs = dict(seq_x=rng.standard_normal((32, 16)).astype(np.float32),
                  seq_g=rng.standard_normal((32, 16)).astype(np.float32),
                  pipe_x=rng.standard_normal((32, 8)).astype(np.float32))
    w = rng.standard_normal((8, 1)).astype(np.float32)
    inputs["pipe_y"] = (inputs["pipe_x"] @ w).astype(np.float32)
    _, stages, _ = _jax_parts((16, 16, 16), 1)
    for i, st in enumerate(stages):
        _put(inputs, f"seq/stage{i}/", st)
    embed, stages, head = _jax_parts((8, 16, 1), 2)
    _put(inputs, "pipe/embed/", embed)
    for i, st in enumerate(stages):
        _put(inputs, f"pipe/stage{i}/", st)
    _put(inputs, "pipe/head/", head)
    return inputs


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = _inputs()
    outs = W.run_job("pipeline", tmp_path_factory.mktemp("pipeline"), WORLD,
                     inputs, timeout_s=240)
    return inputs, outs


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1e-3, np.abs(want).max()),
                               err_msg=what)


def test_gpipe_matches_jax_schedule_and_its_gradient(job):
    inputs, outs = job
    _, stages, _ = _jax_parts((16, 16, 16), 1)
    mesh = jax_mesh({"pp": WORLD}, allow_submesh=True)
    template = stages[0]

    def stage_fn(params, xb):
        return functional_call(template, params, None, xb)

    stacked = jax_stack(stages)

    def f(x):
        return jax_gpipe(stage_fn, stacked, x, W.PIPE_MICRO, mesh)

    x = jnp.asarray(inputs["seq_x"])
    y = f(x)
    dx = jax.grad(lambda xx: jnp.sum(f(xx) * jnp.asarray(inputs["seq_g"])))(x)
    # and the schedule is the stages' composition
    seq = x
    for st in stages:
        seq = st(seq)
    _close(np.asarray(y), np.asarray(seq), 2e-4, "jax gpipe")
    for r, out in enumerate(outs):
        _close(out["gpipe/y"], np.asarray(y), TOL, f"y r{r}")
        _close(out["gpipe/dx"], np.asarray(dx), TOL, f"dx r{r}")


def test_stack_stage_params_matches_jax():
    import torch

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import load_jax_params
    _, jstages, _ = _jax_parts((16, 16, 16), 1)
    stages = [nn.Sequential(nn.Linear(16, 16, device="cpu"), nn.Tanh())
              for _ in range(WORLD)]
    for st, js in zip(stages, jstages):
        load_jax_params(st, {k: np.asarray(v)
                             for k, v in js.param_dict().items()})
    got = ppipe.stack_stage_params(stages)
    want = jax_stack(jstages)
    assert sorted(got) == sorted(want)
    for k in got:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _jax_train(remat=False):
    embed, stages, head = _jax_parts((8, 16, 1), 2)
    step = JaxGPipe(embed, stages, head, jpt.optimizer.Adam(1e-2),
                    lambda o, t: JL.mse_loss(o, t),
                    jax_mesh({"pp": WORLD}, allow_submesh=True),
                    num_microbatches=W.PIPE_MICRO, remat_stages=remat)
    return step


def test_gpipe_train_step_matches_jax(job):
    """Embed and head run on every rank, outside the pipeline (as the JAX
    program runs them replicated): every rank holds the same embed and
    head and its own stage, each the JAX step's."""
    inputs, outs = job
    step = _jax_train()
    losses = [float(step(inputs["pipe_x"], labels=(inputs["pipe_y"],))[
        "loss"]) for _ in range(W.PIPE_STEPS)]
    params = step.state["params"]
    for r, out in enumerate(outs):
        assert int(out["plain/stage_id"]) == r
        _close(out["plain/loss"], losses, TOL, f"loss r{r}")
        for part in ("embed", "head"):
            for n, v in params[part].items():
                _close(out[f"plain/param/{part}.{n}"], np.asarray(v), TOL,
                       f"{part}.{n} r{r}")
        for n, v in params["stages"].items():
            _close(out[f"plain/param/stages.{n}"], np.asarray(v)[r], TOL,
                   f"stages.{n} r{r}")
    assert losses[-1] < losses[0]


def test_remat_stages_matches_plain(job):
    """Recomputing the stages in the backward changes no number (the JAX
    test's bound)."""
    _, outs = job
    for out in outs:
        np.testing.assert_allclose(out["remat/loss"], out["plain/loss"],
                                   rtol=1e-6)
        for k in out:
            if k.startswith("plain/param/"):
                np.testing.assert_allclose(
                    out[k.replace("plain/", "remat/")], out[k], rtol=1e-6,
                    atol=1e-7)


def test_gpipe_train_step_refuses_the_fused_state():
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import create_mesh
    embed, stages, head = W.pipe_parts("cpu", n_stages=1)
    with pytest.raises(ValueError, match="optimizer_fused_state"):
        ppipe.GPipeTrainStep(embed, stages, head, Adam(1e-2,
                                                       fused_state=True),
                             lambda o, t: o.sum(), create_mesh({"pp": 1}), 1)
    with pytest.raises(ValueError, match="need 1 stages"):
        ppipe.GPipeTrainStep(embed, stages * 2, head, Adam(1e-2),
                             lambda o, t: o.sum(), create_mesh({"pp": 1}), 1)
