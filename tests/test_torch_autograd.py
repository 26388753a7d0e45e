"""PyTorch port: ``autograd`` (``grad``, ``value_and_grad``,
``jacobian``, ``hessian``, ``vjp``, ``jvp``, ``no_grad``,
``stop_gradient``) and ``tensor`` against the JAX package on the same
functions, within 1e-5 (fp32). The functions use only arithmetic and
methods both array types have, so one definition serves both."""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import autograd as JA  # noqa: E402
from paddle_tpu import tensor as JT  # noqa: E402

from paddle_tpu_torch import autograd as A  # noqa: E402
from paddle_tpu_torch import tensor as T  # noqa: E402

TOL = 1e-5
R = np.random.default_rng(0)
X = R.normal(size=(3,)).astype(np.float32)
Y = R.normal(size=(3,)).astype(np.float32)


def f(x):
    return (x * x * x).sum() + (x[0] * x[1])


def g(x, y):
    return (x * y + x * x).sum()


def vec(x):
    return x * x + x[::-1] * 2 if isinstance(x, np.ndarray) else \
        x * x + x.flip(0) * 2 if isinstance(x, torch.Tensor) else \
        x * x + x[::-1] * 2


def with_aux(x):
    return (x * x).sum(), x * 3


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
        return
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=TOL, atol=TOL)


def _tx():
    return torch.from_numpy(X.copy())


def _ty():
    return torch.from_numpy(Y.copy())


@pytest.mark.parametrize("case", ["grad", "grad_argnums", "grad_aux",
                                  "value_and_grad", "value_and_grad_aux",
                                  "jacobian_rev", "jacobian_fwd",
                                  "hessian", "vjp", "vjp_aux", "jvp"])
def test_transform_matches_jax(case):
    jx, jy = jnp.asarray(X), jnp.asarray(Y)
    tx, ty = _tx(), _ty()
    if case == "grad":
        _close(A.grad(f)(tx), JA.grad(f)(jx))
    elif case == "grad_argnums":
        _close(A.grad(g, argnums=(0, 1))(tx, ty),
               JA.grad(g, argnums=(0, 1))(jx, jy))
    elif case == "grad_aux":
        _close(A.grad(with_aux, has_aux=True)(tx),
               JA.grad(with_aux, has_aux=True)(jx))
    elif case == "value_and_grad":
        _close(A.value_and_grad(g, argnums=1)(tx, ty),
               JA.value_and_grad(g, argnums=1)(jx, jy))
    elif case == "value_and_grad_aux":
        (v, aux), gr = A.value_and_grad(with_aux, has_aux=True)(tx)
        (jv, jaux), jgr = JA.value_and_grad(with_aux, has_aux=True)(jx)
        _close((v, aux, gr), (jv, jaux, jgr))
    elif case == "jacobian_rev":
        _close(A.jacobian(vec)(tx), JA.jacobian(vec)(jx))
    elif case == "jacobian_fwd":
        _close(A.jacobian(vec, mode="forward")(tx),
               JA.jacobian(vec, mode="forward")(jx))
    elif case == "hessian":
        _close(A.hessian(f)(tx), JA.hessian(f)(jx))
    elif case == "vjp":
        out, fn = A.vjp(vec, tx)
        jout, jfn = JA.vjp(vec, jx)
        _close(out, jout)
        _close(fn(ty), jfn(jy))
    elif case == "vjp_aux":
        out, fn, aux = A.vjp(with_aux, tx, has_aux=True)
        jout, jfn, jaux = JA.vjp(with_aux, jx, has_aux=True)
        _close((out, aux), (jout, jaux))
        _close(fn(torch.tensor(2.0)), jfn(jnp.asarray(2.0)))
    elif case == "jvp":
        _close(A.jvp(vec, (tx,), (ty,)), JA.jvp(vec, (jx,), (jy,)))


def test_tape_style_grad_is_refused_as_in_jax():
    for mod in (A, JA):
        with pytest.raises(TypeError, match="tape-style"):
            mod.grad([1.0], [2.0])


def test_no_grad_and_stop_gradient():
    for mod in (A, JA):
        assert not mod.in_no_grad()
        with mod.no_grad():
            assert mod.in_no_grad()
        assert not mod.in_no_grad()
    x = _tx().requires_grad_(True)
    with A.no_grad():
        y = x * 2
    assert not y.requires_grad  # torch records nothing inside
    z = A.stop_gradient(x * 2)
    assert not z.requires_grad
    _close(A.grad(lambda v: (A.stop_gradient(v) * v).sum())(_tx()),
           JA.grad(lambda v: (JA.stop_gradient(v) * v).sum())(
               jnp.asarray(X)))


def test_tensor_facade():
    t = T.to_tensor([1.5, 2.5], place="cpu")
    j = JT.to_tensor([1.5, 2.5])
    assert t.dtype == torch.float32 and j.dtype == jnp.float32
    _close(t, j)
    t64 = T.to_tensor(np.arange(3), place="cpu")
    assert t64.dtype == torch.int64
    assert T.to_tensor(X, dtype="float16", place="cpu").dtype \
        == torch.float16
    leaf = T.to_tensor(X, place="cpu", stop_gradient=False)
    assert leaf.requires_grad and leaf.is_leaf
    assert T.is_tensor(t) and not T.is_tensor(X)
    np.testing.assert_array_equal(T.to_numpy(t), JT.to_numpy(j))
    assert T.Tensor is torch.Tensor
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.to_tensor([1.0])  # the card by default
