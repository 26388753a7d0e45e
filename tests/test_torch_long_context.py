"""PyTorch port: ring attention (the online-softmax fold and the flash
route, B8 per hop) and Ulysses attention at sp 4, against the JAX
package's ``ring_attention``/``ulysses_attention``.

The port runs in four Gloo processes (``paddle_tpu_torch.testing.
dist_worker``, job ``long_context``, one job for the module): rank r holds
block r of the sequence, as shard r of the JAX arrays, which run on four of
the conftest's eight virtual CPU devices (``create_mesh({"sp": 4},
allow_submesh=True)``), the flash routes under the Pallas interpreter. On
the CPU the port's flash route runs the kernels' plain version
(``flash_attention_with_lse_plain`` per hop). The shapes are
``tests/test_long_context.py``'s ([2, 4, 64, 16]). Forward within 1e-5
and ``dq``/``dk``/``dv`` within 1e-4 of the reference's largest entry
(fp32, another summation order).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.parallel import create_mesh as jax_mesh  # noqa: E402
from paddle_tpu.parallel.long_context import (  # noqa: E402
    ring_attention as jax_ring, ulysses_attention as jax_ulysses)

from paddle_tpu_torch.testing import dist_worker as W  # noqa: E402

WORLD = 4
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {n: rng.standard_normal((2, 4, 64, 16)).astype(np.float32)
              for n in ("q", "k", "v", "g")}
    inputs["kinds"] = np.asarray(sorted({k for k, _ in W.LC_CASES}))
    outs = W.run_job("long_context", tmp_path_factory.mktemp("lc"), WORLD,
                     inputs, timeout_s=120)
    return inputs, outs


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("kind,causal", W.LC_CASES)
def test_long_context_matches_jax_forward_and_gradients(job, kind, causal):
    inputs, outs = job
    mesh = jax_mesh({"sp": WORLD}, allow_submesh=True)
    fn = jax_ring if kind.startswith("ring") else jax_ulysses
    flash = kind.endswith("flash")

    def f(q, k, v):
        return fn(q, k, v, mesh, "sp", causal=causal, use_flash=flash,
                  interpret=True)

    q, k, v, g = (jnp.asarray(inputs[n]) for n in "qkvg")

    def loss(*a):
        o = f(*a)
        return jnp.sum(o * g), o

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    out = np.asarray(out)
    tag = f"{kind}/{'causal' if causal else 'full'}"
    t = 64 // WORLD
    for r, o in enumerate(outs):
        sl = slice(r * t, (r + 1) * t)
        _close(o[f"{tag}/out"], out[:, :, sl], FWD_TOL, f"{tag} out r{r}")
        for name, gr in zip(("dq", "dk", "dv"), grads):
            _close(o[f"{tag}/{name}"], np.asarray(gr)[:, :, sl], GRAD_TOL,
                   f"{tag} {name} r{r}")


def test_ulysses_refuses_heads_that_do_not_split(job):
    _, outs = job
    for o in outs:
        assert "not divisible by sp=4" in str(o["heads_error"])
    mesh = jax_mesh({"sp": WORLD}, allow_submesh=True)
    bad = jnp.zeros((1, 6, 16, 8))
    with pytest.raises(ValueError, match="not divisible by sp=4"):
        jax_ulysses(bad, bad, bad, mesh, "sp")
