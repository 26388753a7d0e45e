"""PyTorch port: bf16 operands through the CUDA wrappers' cast path.

The JAX kernels compute on bf16 inputs: LayerNorm reads them as fp32
and writes x's dtype, flash attention returns out and every gradient in
the inputs' dtypes, the fused softmax cross-entropy returns an fp32 loss
and gradients in each input's dtype. The port's wrappers cast bf16 and
fp16 operands to fp32 on the way in, run the fp32 kernels, and cast back
on the way out, in one autograd Function per kernel. That Function takes
its kernel functions as an argument, so here it runs with the kernels'
plain stand-ins (``forward=layer_norm_plain``, ``PLAIN_KERNELS``) on CPU
tensors, held against the JAX functions in interpret mode on the same
bf16 inputs, with every output and gradient dtype asserted. On the card
``chip_smoke.py`` runs the same cast path with the CUDA kernels.

Tolerances: both sides compute in fp32 from the same bf16 values and
round once to bf16, so outputs agree to one bf16 step (``BF16_RES`` of
the largest entry) where nothing else differs. The JAX tests' own bf16
bounds hold where the two sides' fp32 intermediates differ by more: the
xent loss (2e-2, ``tests/test_fused_loss.py``) and the flash gradients
(0.1, ``tests/test_kernels.py``: the JAX backward forms delta from the
bf16-rounded output, the port from the fp32 one).
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import flash_attention as jax_fa  # noqa: E402
from paddle_tpu.kernels.fused_softmax_xent import \
    fused_linear_softmax_xent  # noqa: E402
from paddle_tpu.kernels.layer_norm import layer_norm_pallas  # noqa: E402

from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import fused_softmax_xent as fx  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as ln  # noqa: E402

# one bf16 rounding step, relative to the largest entry (8 significant
# bits: a value in [2^e, 2^(e+1)) rounds in steps of 2^(e-7))
BF16_RES = 2.0 ** -7
XENT_LOSS_TOL = 2e-2
FLASH_GRAD_TOL = 0.1


def _bf16(a):
    """The same numpy values as a torch bf16 tensor and a JAX bf16
    array."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(a, jnp.bfloat16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, tol, what):
    g, w = _np(got), _np(want)
    err = float(np.max(np.abs(g - w)))
    assert err <= tol * max(float(np.max(np.abs(w))), 1.0), (what, err)


@pytest.fixture
def jax_tiles(monkeypatch):
    monkeypatch.setattr(jax_fa, "BLOCK_Q", 32)
    monkeypatch.setattr(jax_fa, "BLOCK_K", 32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_layer_norm_cast_path_dtypes(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 32), np.float32)).to(
        dtype).requires_grad_()
    w = torch.ones(32, dtype=dtype, requires_grad=True)
    b = torch.zeros(32, dtype=torch.float32, requires_grad=True)
    y = ln.layer_norm(x, w, b, 1e-5, forward=ln.layer_norm_plain)
    assert y.dtype == dtype
    assert ln.layer_norm_plain(x, w, b).dtype == dtype
    y.float().sum().backward()
    assert (x.grad.dtype, w.grad.dtype, b.grad.dtype) == (
        dtype, dtype, torch.float32)
    with pytest.raises(TypeError, match="layer_norm takes"):
        ln.layer_norm(x.double(), w, b, forward=ln.layer_norm_plain)


def test_layer_norm_bf16_matches_jax():
    rng = np.random.default_rng(2)
    rows, cols, eps = 16, 128, 1e-5
    x, jx = _bf16(rng.standard_normal((rows, cols)))
    w, jw = _bf16(1 + 0.1 * rng.standard_normal(cols))
    b, jb = _bf16(0.1 * rng.standard_normal(cols))
    g = rng.standard_normal((rows, cols)).astype(np.float32)

    def jax_loss(x_, w_, b_):
        y = layer_norm_pallas(x_, w_, b_, eps, interpret=True)
        return jnp.sum(y.astype(jnp.float32) * g), y

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(jx, jw, jb)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    got = ln.layer_norm(*leaves, eps, forward=ln.layer_norm_plain)
    (got.float() * torch.from_numpy(g)).sum().backward()
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, BF16_RES, "out")
    for name, t, jg in zip(("dx", "dw", "db"), leaves, jgrads):
        assert t.grad.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16
        _close(t.grad, jg, BF16_RES, name)


# (layout, causal, key bias, B, H, T, D, dropout p): T = 24 takes the
# fused backward in both packages (one 32-row JAX tile, the port's 128
# rows), 64 the JAX dq + dkv pair and the port's fused kernel, 136 the
# dq + dkv pair in both
FLASH_CASES = [
    ("bhtd", True, False, 1, 2, 24, 32, 0.1),
    ("bthd", False, True, 1, 2, 64, 64, 0.0),
    ("bhtd", True, True, 1, 2, 136, 32, 0.1),
]


@pytest.mark.parametrize("layout,causal,bias,b,h,t,d,p", FLASH_CASES)
def test_flash_bf16_matches_jax(jax_tiles, layout, causal, bias, b, h, t,
                                d, p):
    rng = np.random.default_rng(t + d)
    bthd = layout == "bthd"
    shape = (b, t, h, d) if bthd else (b, h, t, d)
    (q, jq), (k, jk), (v, jv) = (_bf16(rng.standard_normal(shape))
                                 for _ in range(3))
    ct = rng.standard_normal(shape).astype(np.float32)
    kv_bias = None
    if bias:
        keep = rng.random((b, t)) < 0.8
        keep[:, 0] = True
        kv_bias = np.where(keep, 0.0, np.finfo(np.float32).min).astype(
            np.float32)
    seed = 4321 + t

    def jax_loss(q_, k_, v_):
        out = jax_fa.flash_attention(
            q_, k_, v_, causal, None, True, p,
            jnp.int32(seed) if p else None,
            None if kv_bias is None else jnp.asarray(kv_bias), bthd)
        return jnp.sum(out.astype(jnp.float32) * ct), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = fa.flash_attention(
        *leaves, causal=causal, dropout_p=p,
        seed=torch.tensor([seed], dtype=torch.int32) if p else None,
        kv_bias=None if kv_bias is None else torch.from_numpy(
            kv_bias).to(torch.bfloat16),
        bthd=bthd, kernels=fa.PLAIN_KERNELS)
    (got.float() * torch.from_numpy(ct)).sum().backward()
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, BF16_RES, "out")
    for name, x, jg in zip(("dq", "dk", "dv"), leaves, jgrads):
        assert x.grad.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16
        _close(x.grad, jg, FLASH_GRAD_TOL, name)


def test_flash_plain_bf16_dtypes():
    # the plain version the CPU router takes: out in q's dtype, lse fp32,
    # gradients in each input's dtype
    q, k, v = (torch.randn(1, 2, 8, 16, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    out.float().sum().backward()
    assert all(x.grad.dtype == torch.bfloat16 for x in (q, k, v))
    with pytest.raises(TypeError, match="flash attention takes"):
        fa.flash_attention(q.double(), k, v, kernels=fa.PLAIN_KERNELS)


@pytest.mark.parametrize("bias", [True, False])
def test_fused_xent_bf16_matches_jax(bias):
    rng = np.random.default_rng(5 + bias)
    n, vocab, hd = 14, 300, 32
    h, jh = _bf16(rng.standard_normal((n, hd)))
    w, jw = _bf16(0.5 * rng.standard_normal((vocab, hd)))
    b = rng.standard_normal(vocab).astype(np.float32) if bias else None
    lab = rng.integers(0, vocab, n).astype(np.int64)
    lab[rng.random(n) < 0.25] = -100

    def jax_loss(h_, w_, b_):
        loss = fused_linear_softmax_xent(h_, w_, b_, jnp.asarray(lab),
                                         ignore_index=-100, interpret=True)
        return jnp.mean(loss), loss

    argnums = (0, 1, 2) if bias else (0, 1)
    jb = None if b is None else jnp.asarray(b)
    (_, want), jgrads = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(jh, jw, jb)
    leaves = [h.clone().requires_grad_(), w.clone().requires_grad_()]
    if bias:
        leaves.append(torch.from_numpy(b).requires_grad_())
    got = fx.fused_linear_xent(leaves[0], leaves[1],
                               leaves[2] if bias else None,
                               torch.from_numpy(lab),
                               kernels=fx.PLAIN_KERNELS)
    got.mean().backward()
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, XENT_LOSS_TOL, "loss")
    assert bool((got[torch.from_numpy(lab) == -100] == 0).all())
    for name, x, jg in zip(("dh", "dW", "db"), leaves, jgrads):
        assert x.grad.dtype == x.dtype and str(jg.dtype) == str(
            x.dtype).replace("torch.", "")
        _close(x.grad, jg, BF16_RES, name)
    # the plain version the CPU router takes gives the same dtypes
    plain = fx.fused_linear_xent_plain(h, w, None, torch.from_numpy(lab))
    assert plain.dtype == torch.float32
