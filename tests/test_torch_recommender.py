"""PyTorch port: ``models.recommender`` against the JAX package on the
CPU.

``RecommenderSystem`` (small towers) and ``DeepFM`` (three fields): the
loss and every parameter's gradient within ``TOL`` of the reference's
largest entry (fp32, sums in another order). ``RecommenderSystem`` at
its MovieLens-1M defaults fed by ``datasets.Movielens(mode="synthetic")``
through ``hapi.Model.fit`` lowers the loss; ``DeepFM`` learns a
second-order interaction, as the JAX package's test has it.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import paddle_tpu as jpt  # noqa: E402
from paddle_tpu import models as jm  # noqa: E402

from paddle_tpu_torch import hapi, models as pm  # noqa: E402
from paddle_tpu_torch.convert import load_jax_params  # noqa: E402
from paddle_tpu_torch.data import DataLoader  # noqa: E402
from paddle_tpu_torch.datasets import Movielens  # noqa: E402
from paddle_tpu_torch.nn.layer import Layer  # noqa: E402
from paddle_tpu_torch.optimizer import Adam  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

TOL = 1e-5
RNG = np.random.default_rng(0)


def _close(got, want, what=""):
    g = got.detach().numpy()
    w = np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.max(np.abs(w), initial=0.0)), 1e-30)
    err = float(np.max(np.abs(g - w), initial=0.0)) / scale
    assert err <= TOL, (what, err)


def _pair(jmodel, pmodel, jloss, ploss):
    load_jax_params(pmodel, {k: np.asarray(v)
                             for k, v in jmodel.param_dict().items()})

    @jax.jit
    def f(p):
        with jmodel.bind(p):
            return jloss(jmodel)

    jl, jg = jax.value_and_grad(f)(jmodel.param_dict())
    pl = ploss(pmodel)
    pl.backward()
    _close(pl, jl, "loss")
    grads = {n: p.grad for n, p in pmodel.named_parameters()}
    assert set(grads) == set(jg)
    for n in jg:
        _close(grads[n], jg[n], f"d {n}")


def _ratings(b=32, users=50, movies=60):
    u = np.stack([RNG.integers(0, users, b), RNG.integers(0, 2, b),
                  RNG.integers(0, 7, b), RNG.integers(0, 21, b)], 1)
    m = np.stack([RNG.integers(0, movies, b), RNG.integers(0, 19, b)], 1)
    return u, m, RNG.uniform(1, 5, (b, 1)).astype(np.float32)


def test_recommender_system_matches_jax():
    kw = dict(n_users=50, n_movies=60, embed_dim=8, hidden=32)
    jpt.seed(0)
    jmodel = jm.RecommenderSystem(**kw)
    pmodel = pm.RecommenderSystem(**kw, device="cpu")
    u, m, r = _ratings()
    _pair(jmodel, pmodel,
          lambda md: md.loss(jnp.asarray(u), jnp.asarray(m), jnp.asarray(r)),
          lambda md: md.loss(torch.from_numpy(u), torch.from_numpy(m),
                             torch.from_numpy(r)))


def test_deepfm_matches_jax():
    fields = [20, 30, 10]
    jpt.seed(1)
    jmodel = jm.DeepFM(fields, embed_dim=8, hidden=(32, 16))
    pmodel = pm.DeepFM(fields, embed_dim=8, hidden=(32, 16), device="cpu")
    x = np.stack([RNG.integers(0, c, 64) for c in fields], 1)
    y = RNG.integers(0, 2, 64)
    _pair(jmodel, pmodel,
          lambda md: md.loss(jnp.asarray(x), jnp.asarray(y)),
          lambda md: md.loss(torch.from_numpy(x), torch.from_numpy(y)))


class Ratings(Layer):
    """A Movielens row (user id, gender, age, job, movie id, category)
    into the two towers."""

    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def forward(self, row):
        return self.rec(row[:, :4], row[:, 4:])


def test_fit_on_movielens_lowers_the_loss():
    net = Ratings(pm.RecommenderSystem(device="cpu"))
    model = hapi.Model(net)
    model.prepare(optimizer=Adam(learning_rate=2e-3),
                  loss=lambda pred, r: torch.mean((pred - r) ** 2))
    loader = DataLoader(Movielens(mode="synthetic"), batch_size=64)
    hist = model.fit(loader, epochs=4, verbose=0)
    assert hist["loss"][-1] < hist["loss"][0], hist["loss"]


def test_deepfm_learns_feature_interaction():
    fields = [20, 20, 10]
    model = pm.DeepFM(fields, embed_dim=8, hidden=(32, 16), device="cpu")

    class _M(Layer):
        def __init__(self):
            super().__init__()
            self.inner = model

        def forward(self, f, y):
            return self.inner.loss(f, y)

    step = TrainStep(_M(), Adam(learning_rate=5e-3), lambda out: out)
    x = np.stack([RNG.integers(0, c, 256) for c in fields], 1)
    # click iff field 0 and field 1 have the same parity (a pure
    # second-order interaction, which the FM term models)
    y = ((x[:, 0] % 2) == (x[:, 1] % 2)).astype(np.int64)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    first = float(step(xt, yt, labels=())["loss"])
    for _ in range(60):
        last = float(step(xt, yt, labels=())["loss"])
    assert last < first * 0.7, (first, last)
