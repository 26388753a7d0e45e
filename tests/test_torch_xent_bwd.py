"""PyTorch port: the chunked backward of the fused linear + softmax
cross-entropy against the JAX package's backward on the CPU.

The CUDA kernels of the backward (a dlog, a dW/db and a dh kernel per
vocabulary chunk) run only on a GPU (``python3 chip_smoke.py`` holds them
against their plain version there). Here their plain version,
``fused_xent_bwd_chunked_plain``, which follows the same decomposition
(the same chunk, chunk order and zero rule for ignored rows), is held
against the JAX package's ``_backward`` (its ``_bwd_dh_kernel`` and
``_bwd_dw_kernel`` in interpret mode) on the same numpy inputs and the
same ``lse``, within 1e-5 of each gradient's largest entry.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import fused_softmax_xent as jax_fx  # noqa: E402

from paddle_tpu_torch.kernels import fused_softmax_xent as fx  # noqa: E402

# as tests/test_torch_fused_xent.py: fp32 gradients summed over up to 1024
# vocab columns (1600 hidden columns) in another order, relative to each
# gradient's largest entry
GRAD_TOL = 1e-5

# (name, N, V, H, bias, ignored share, chunk): the fused-xent file's
# shapes (ragged rows, vocab one tile short, one past, exact), no bias, V
# not a multiple of the chunk, a chunk wider than V, every row ignored,
# and H = 1600 (GPT-2-XL's width)
CASES = [
    ("n14_v300_h32", 14, 300, 32, True, 0.3, None),
    ("n13_v513_h64", 13, 513, 64, True, 0.3, None),
    ("n15_v1024_h48", 15, 1024, 48, True, 0.3, None),
    ("no_bias", 14, 300, 32, False, 0.3, None),
    ("v300_chunk128", 21, 300, 32, True, 0.2, 128),
    ("v1024_chunk384", 15, 1024, 48, True, 0.2, 384),
    ("chunk_wider_than_v", 9, 200, 16, True, 0.2, 2048),
    ("all_rows_ignored", 12, 300, 32, True, 1.0, 128),
    ("h1600", 10, 200, 1600, True, 0.3, 128),
]


def _inputs(n, v, h, ignored, seed):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((n, h)).astype(np.float32)
    weight = (rng.standard_normal((v, h)) / np.sqrt(h)).astype(np.float32)
    bias = rng.standard_normal((v,)).astype(np.float32)
    labels = rng.integers(0, v, n).astype(np.int64)
    labels = np.where(rng.random(n) < ignored, -100, labels)
    labels[0] = -100  # at least one ignored row
    g = rng.standard_normal(n).astype(np.float32)
    return hidden, weight, bias, labels, g


def _jax_backward(hidden, weight, bias, labels, g):
    """The JAX package's forward lse and backward (dh, dw, db) with its
    Pallas kernels in interpret mode, tiles as fused_linear_softmax_xent
    picks them."""
    n, v = hidden.shape[0], weight.shape[0]
    bn = min(jax_fx._ROW_BLOCK, jax_fx._ceil_to(n, 8))
    bv = min(jax_fx._VOCAB_BLOCK, jax_fx._ceil_to(v, 128))
    h2, w = jnp.asarray(hidden), jnp.asarray(weight)
    b2 = jnp.asarray(bias) if bias is not None \
        else jnp.zeros((v,), jnp.float32)
    lab = jnp.asarray(labels.astype(np.int32))
    _, lse = jax_fx._forward(h2, w, b2, lab, -100, bn, bv, True)
    dh, dw, db = jax_fx._backward((h2, w, b2, lab, lse), jnp.asarray(g),
                                  -100, bn, bv, True)
    return np.array(lse), [np.array(x) for x in (dh, dw, db)]


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    gap = float(np.max(np.abs(got.numpy() - want)))
    return 0.0 if gap == 0.0 else gap / max(float(np.max(np.abs(want))),
                                            1e-30)


@pytest.mark.parametrize("name,n,v,h,bias,ignored,chunk", CASES,
                         ids=[c[0] for c in CASES])
def test_chunked_plain_matches_jax_backward(name, n, v, h, bias, ignored,
                                            chunk):
    hidden, weight, b, labels, g = _inputs(n, v, h, ignored, seed=n + v + h)
    b = b if bias else None
    lse, want = _jax_backward(hidden, weight, b, labels, g)
    got = fx.fused_xent_bwd_chunked_plain(
        torch.from_numpy(hidden), torch.from_numpy(weight),
        None if b is None else torch.from_numpy(b),
        torch.from_numpy(labels), torch.from_numpy(lse),
        torch.from_numpy(g), chunk=chunk)
    assert (got[2] is None) == (b is None)
    for gname, x, w in zip(("dh", "dw", "db"), got, want):
        if x is None:
            continue  # no bias: JAX's db is that of a zero bias
        assert x.shape == w.shape, gname
        assert _rel(x, w) <= GRAD_TOL, (gname, _rel(x, w))
    # an ignored row's gradient is exactly 0
    ignored_rows = labels == -100
    assert np.all(got[0].numpy()[ignored_rows] == 0.0)
    if ignored_rows.all():
        assert not any(bool(x.count_nonzero()) for x in got
                       if x is not None)


@pytest.mark.parametrize("n,v,chunk", [
    (4096, 30522, 2048), (1024, 30522, 2048), (77, 300, 384),
    (1000, 513, 640), (65536, 30522, 1024), (10 ** 6, 30522, 128)])
def test_backward_chunk(n, v, chunk):
    # 2048 columns (a 32 MB chunk of dlog at N = 4096, in the 50 MB L2),
    # fewer where the [N, Vc] scratch would pass 256 MB, at most V rounded
    # up to the 128-row tile; never a function of H
    assert fx.bwd_chunk(n, v) == chunk
    assert chunk % 128 == 0


def test_no_hidden_size_cap():
    # the chunked products take H as a loop bound only: no per-H shared
    # memory, no cap; a CPU tensor of any H meets the device check
    assert not hasattr(fx, "MAX_HIDDEN")
    src = (fx._build.CSRC / "fused_softmax_xent.cu").read_text()
    assert "bwd_smem" not in src and "MAX_HIDDEN" not in src
    h = torch.zeros(4, 4096)
    with pytest.raises(ValueError, match="CUDA"):
        fx.xent_bwd(h, torch.zeros(10, 4096), None,
                    torch.zeros(4, dtype=torch.int64), torch.zeros(4),
                    torch.ones(4))
