"""PyTorch port: flash attention and the LayerNorm gradient against the
JAX package.

The CUDA kernels run only on a GPU (``python3 chip_smoke.py`` holds them
against their plain versions there). Here the port's plain flash version
is held against the Pallas kernels in interpret mode, forward and
``jax.grad``, on the same numpy inputs, with BLOCK_Q/BLOCK_K patched to
32 so that both JAX backward routes (the fused single-tile kernel and
the dq + dkv pair) are compared. The dropout keep masks must be
identical: the port reproduces the JAX kernels' counter hash bit for
bit, so the tolerances below are fp32 summation-order tolerances even
at dropout 0.1. Also checked: the port's backward-route rule, the
routing gate, the LayerNorm backward, that the CUDA wrappers refuse
CPU tensors, and ``flash_attention_with_lse`` (its plain version, the
autograd Function over the kernels' plain stand-ins, and its router)
against the JAX entry of that name with both cotangents nonzero.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.kernels import _mask_to_kv_bias as jax_mask_to_kv_bias  # noqa: E402,E501
from paddle_tpu.kernels import flash_attention as jax_fa  # noqa: E402
from paddle_tpu.kernels.layer_norm import layer_norm_pallas  # noqa: E402

from paddle_tpu_torch import kernels, set_flags  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as ln  # noqa: E402

# fp32 tolerances: the same arithmetic summed in another order (the
# masks are bitwise equal, so dropout adds no slack)
OUT_TOL = 2e-5
GRAD_TOL = 5e-5


@pytest.fixture
def jax_tiles(monkeypatch):
    monkeypatch.setattr(jax_fa, "BLOCK_Q", 32)
    monkeypatch.setattr(jax_fa, "BLOCK_K", 32)


def _inputs(b, h, tq, tk, d, bthd, bias, seed):
    rng = np.random.default_rng(seed)
    shape = (lambda t: (b, t, h, d)) if bthd else (lambda t: (b, h, t, d))
    q = rng.standard_normal(shape(tq), np.float32)
    k = rng.standard_normal(shape(tk), np.float32)
    v = rng.standard_normal(shape(tk), np.float32)
    ct = rng.standard_normal(shape(tq), np.float32)
    kv_bias = None
    if bias:
        keep = rng.random((b, tk)) < 0.8
        keep[:, 0] = True  # every row keeps a key
        kv_bias = np.where(keep, 0.0, np.finfo(np.float32).min) \
            .astype(np.float32)
    return q, k, v, ct, kv_bias


# (layout, causal, key bias, B, H, Tq, Tk, D, dropout p): the JAX BTHD
# layout needs D = 64 with an even head count; Tq/Tk <= 32 take the JAX
# fused backward, longer ones its dq + dkv pair; 50 and 40 are ragged
CASES = [
    ("bhtd", False, False, 2, 2, 64, 64, 16, 0.0),
    ("bthd", True, False, 2, 2, 50, 50, 64, 0.0),
    ("bthd", False, True, 1, 2, 40, 40, 64, 0.1),
    ("bhtd", True, True, 2, 2, 24, 24, 32, 0.1),
    ("bhtd", True, False, 1, 2, 24, 72, 16, 0.1),
    ("bthd", False, False, 1, 2, 20, 20, 64, 0.1),
    # above 512, where the CUDA kernels run head-dim slices (640 as two
    # of 384): the dq + dkv pair, and one 32-row tile of the fused kernel
    ("bhtd", True, True, 1, 2, 24, 40, 640, 0.1),
    ("bhtd", False, False, 1, 1, 20, 20, 640, 0.0),
]


@pytest.mark.parametrize("layout,causal,bias,b,h,tq,tk,d,p", CASES)
def test_plain_matches_jax_kernel(jax_tiles, layout, causal, bias, b, h,
                                  tq, tk, d, p):
    bthd = layout == "bthd"
    q, k, v, ct, kv_bias = _inputs(b, h, tq, tk, d, bthd, bias, seed=tq)
    seed = 1234 + tk

    def jax_loss(q_, k_, v_):
        out = jax_fa.flash_attention(
            q_, k_, v_, causal, None, True, p,
            jnp.int32(seed) if p else None,
            None if kv_bias is None else jnp.asarray(kv_bias), bthd)
        return jnp.sum(out * ct), out

    (_, want), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = fa.flash_attention_plain(
        tq_, tk_, tv_, causal=causal, dropout_p=p,
        seed=torch.tensor([seed], dtype=torch.int32) if p else None,
        kv_bias=None if kv_bias is None else torch.from_numpy(kv_bias),
        bthd=bthd)
    (got * torch.from_numpy(ct)).sum().backward()

    assert np.max(np.abs(got.detach().numpy() - np.asarray(want))) \
        <= OUT_TOL
    for name, t, jg in zip("qkv", (tq_, tk_, tv_), jgrads):
        err = np.max(np.abs(t.grad.numpy() - np.asarray(jg)))
        assert err <= GRAD_TOL, (name, err)


def test_dropout_mask_is_the_jax_hash_bit_for_bit():
    b, h, tq, tk, p, seed = 2, 3, 37, 45, 0.1, 987654321
    got = fa.dropout_keep_mask(torch.tensor([seed], dtype=torch.int32), b,
                               h, tq, tk, p).numpy()
    q_pos = jnp.arange(tq, dtype=jnp.int32)[:, None]
    k_pos = jnp.arange(tk, dtype=jnp.int32)[None, :]
    want = np.stack([np.asarray(jax_fa._dropout_keep(
        jnp.int32(seed), g, q_pos, k_pos, p)) for g in range(b * h)])
    assert np.array_equal(got.reshape(b * h, tq, tk), want)
    assert 0.05 < 1.0 - got.mean() < 0.15
    assert fa.dropout_threshold(p) == min(int(p * 2 ** 32), 2 ** 32 - 1)


def test_plain_lse_and_fully_masked_rows():
    # lse is the row logsumexp of the scaled, biased scores; a causal row
    # with no visible key (Tq > Tk) gives 0 output and no gradient
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 6, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 4, 16), np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 4, 16), np.float32))
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    assert torch.allclose(lse, torch.logsumexp(s, -1), atol=1e-6)
    q.requires_grad_()
    out = fa.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(out[:, :, :2], torch.zeros_like(out[:, :, :2]))
    out.sum().backward()
    assert torch.equal(q.grad[:, :, :2], torch.zeros_like(q.grad[:, :, :2]))


@pytest.mark.parametrize("tq,tk,d,route", [
    (128, 128, 64, "fused"), (129, 128, 64, "split"),
    (128, 129, 64, "split"), (512, 512, 64, "split"),
    (1, 1, 16, "fused"), (77, 100, 32, "fused"),
    (64, 64, 128, "fused"), (65, 64, 128, "split"),
])
def test_backward_route_rule(tq, tk, d, route):
    # the JAX rule (fused when both sequences fit one tile) with the
    # port's tile: 128 rows at D <= 64, 64 at D = 128
    assert fa.backward_route(tq, tk, d) == route
    assert fa.fused_rows(d) == (128 if d <= 64 else 64)


def test_mask_to_kv_bias_matches_jax():
    rng = np.random.default_rng(5)
    keep = rng.random((2, 1, 1, 9)) < 0.6
    add = np.where(keep, 0.0, -3e38).astype(np.float32)
    for m in (keep, add):
        want = np.asarray(jax_mask_to_kv_bias(jnp.asarray(m)))
        got = kernels._mask_to_kv_bias(torch.from_numpy(m)).numpy()
        assert np.array_equal(got, want)


class TestGate:
    """maybe_flash_attention keeps the JAX gate: head dim, a [B,1,1,Tk]
    mask only, and the train/eval minimum key length."""

    def _route(self, monkeypatch, **kw):
        calls = []
        real = fa.flash_attention_plain

        def spy(*a, **k):
            calls.append(k)
            return real(*a, **k)
        monkeypatch.setattr(fa, "flash_attention_plain", spy)
        q = torch.randn(2, kw.pop("t", 16), 2, kw.pop("d", 16))
        mask = kw.pop("mask", None)
        out = kernels.maybe_flash_attention(q, q, q, mask=mask,
                                            layout="bthd", **kw)
        assert out.shape == q.shape
        return calls

    def test_training_at_the_gate_takes_flash(self, monkeypatch):
        set_flags({"flash_attention_min_seq_train": 16})
        try:
            mask = torch.zeros(2, 1, 1, 16)
            calls = self._route(monkeypatch, training=True, dropout_p=0.1,
                                mask=mask)
            assert len(calls) == 1 and calls[0]["dropout_p"] == 0.1
            seed = calls[0]["seed"]
            assert seed.dtype == torch.int32 and seed.shape == (1,)
            assert calls[0]["kv_bias"].shape == (2, 16)
            # below the gate, and eval at a narrow head, stay plain SDPA
            assert not self._route(monkeypatch, training=True, t=15)
            assert not self._route(monkeypatch, training=False)
        finally:
            set_flags({"flash_attention_min_seq_train": 512})

    def test_broadcast_mask_and_odd_head_dim_stay_off_flash(self,
                                                            monkeypatch):
        set_flags({"flash_attention_min_seq_train": 8})
        try:
            assert not self._route(monkeypatch, training=True,
                                   mask=torch.zeros(1, 1, 1, 16))
            assert not self._route(monkeypatch, training=True, d=12)
        finally:
            set_flags({"flash_attention_min_seq_train": 512})

    def test_flash_and_sdpa_agree_without_dropout(self):
        rng = np.random.default_rng(9)
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16),
                                                        np.float32))
                   for _ in range(3))
        mask = torch.zeros(2, 1, 1, 24)
        mask[1, ..., 18:] = torch.finfo(torch.float32).min
        outs = []
        for gate in (16, 512):
            set_flags({"flash_attention_min_seq_train": gate})
            try:
                outs.append(kernels.maybe_flash_attention(
                    q, k, v, mask=mask, training=True, layout="bthd"))
            finally:
                set_flags({"flash_attention_min_seq_train": 512})
        assert float((outs[0] - outs[1]).abs().max()) <= 1e-5


@pytest.mark.parametrize("rows,cols", [(16, 128), (24, 256)])
def test_layer_norm_backward_matches_jax(rows, cols):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((rows, cols), np.float32)
    w = (1 + 0.1 * rng.standard_normal(cols)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cols)).astype(np.float32)
    g = rng.standard_normal((rows, cols), np.float32)
    want = jax.grad(lambda x_, w_, b_: jnp.sum(layer_norm_pallas(
        x_, w_, b_, 1e-12, interpret=True) * g), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ln.layer_norm_backward(*(torch.from_numpy(a)
                                   for a in (x, w, g)), 1e-12)
    for a, e in zip(got, want):
        assert np.max(np.abs(a.numpy() - np.asarray(e))) <= 2e-5
    # and it is the gradient of the plain forward the CPU route runs
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (kernels.maybe_layer_norm(tx, tw, tb, 1e-12, 1)
     * torch.from_numpy(g)).sum().backward()
    for a, t in zip(got, (tx, tw, tb)):
        assert float((a - t.grad).abs().max()) <= 2e-5


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    lse = torch.zeros(1, 2, 8)
    for fn in (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_fused):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm(torch.randn(4, 8, requires_grad=True), torch.ones(8),
                      torch.zeros(8))


def _layout(view):
    if view == "bthd":  # the projections' [B, T, H*D] as heads
        return torch.zeros(2, 8, 32).reshape(2, 8, 2, 16)
    if view == "bhtd":
        return torch.zeros(2, 8, 32).reshape(2, 8, 2, 16).transpose(1, 2)
    if view == "fused_qkv_chunk":  # k of one [d, 3d] projection
        return torch.zeros(2, 8, 96).chunk(3, dim=-1)[1].reshape(2, 8, 2, 16)
    if view == "head_dim_strided":
        return torch.zeros(2, 8, 2, 32)[..., ::2]
    if view == "row_stride_18":
        return torch.zeros(2, 8, 2, 18)[..., :16]
    return torch.zeros(2 * 8 * 2 * 16 + 1)[1:].view(2, 8, 2, 16)


@pytest.mark.parametrize("view,readable", [
    ("bthd", True), ("bhtd", True), ("fused_qkv_chunk", True),
    ("head_dim_strided", False), ("row_stride_18", False),
    ("misaligned", False)])
def test_kernel_readable_layouts(view, readable):
    # the one layout rule of the kernels' 16-byte row loads: every operand
    # is checked against it, and the backward copies a dO that breaks it
    t = _layout(view)
    assert fa._kernel_readable(t) is readable


def test_cpu_routes_count_no_launch():
    kernels.reset_launch_counts()
    set_flags({"flash_attention_min_seq_train": 8})
    try:
        q = torch.randn(1, 8, 2, 16, requires_grad=True)
        kernels.maybe_flash_attention(q, q, q, training=True, dropout_p=0.1,
                                      layout="bthd").sum().backward()
    finally:
        set_flags({"flash_attention_min_seq_train": 512})
    counts = kernels.launch_counts()
    assert set(counts) >= {"flash_attention_fwd", "flash_attention_bwd_fused",
                           "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "layer_norm"}
    assert all(v == 0 for v in counts.values())


# flash_attention_with_lse (the JAX package's entry of that name): (B, H,
# Tq, Tk, D, causal). With BLOCK_Q/BLOCK_K at 32, T = 24 takes the JAX
# fused backward and 72/136 its dq + dkv pair; the port's cast path
# takes its fused route up to 128 rows (D <= 64) and the dq + dkv pair at
# 136, where delta - dlse reaches both of its kernels
LSE_CASES = [
    (1, 2, 24, 24, 32, False),
    (1, 2, 24, 24, 32, True),
    (1, 2, 136, 136, 32, False),
    (1, 2, 136, 136, 16, True),
    (1, 2, 40, 72, 16, True),
]


@pytest.mark.parametrize("b,h,tq,tk,d,causal", LSE_CASES)
def test_flash_with_lse_matches_jax(jax_tiles, b, h, tq, tk, d, causal):
    """(out, lse) and the gradients of sum(out * w1) + sum(lse * w2), both
    cotangents nonzero: the plain version (the CPU router's) and the cast
    path's autograd Function over the kernels' plain stand-ins, which
    folds dlse into delta as the CUDA route does."""
    rng = np.random.default_rng(tq + tk + d)
    q = rng.standard_normal((b, h, tq, d), np.float32)
    k = rng.standard_normal((b, h, tk, d), np.float32)
    v = rng.standard_normal((b, h, tk, d), np.float32)
    w1 = rng.standard_normal((b, h, tq, d), np.float32)
    w2 = rng.standard_normal((b, h, tq), np.float32)

    def jax_loss(q_, k_, v_):
        o, lse = jax_fa.flash_attention_with_lse(q_, k_, v_, causal, None,
                                                 True)
        return jnp.sum(o * w1) + jnp.sum(lse * w2), (o, lse)

    (_, (want_o, want_lse)), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    runs = {
        "plain": lambda *x: fa.flash_attention_with_lse_plain(
            *x, causal=causal),
        "cast_path": lambda *x: fa.flash_attention_with_lse(
            *x, causal=causal, kernels=fa.PLAIN_KERNELS),
        "router": lambda *x: kernels.maybe_flash_attention_with_lse(
            *x, causal=causal),
    }
    for name, run in runs.items():
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        o, lse = run(*leaves)
        assert lse.shape == (b, h, tq) and lse.dtype == torch.float32
        ((o * torch.from_numpy(w1)).sum()
         + (lse * torch.from_numpy(w2)).sum()).backward()
        assert np.max(np.abs(o.detach().numpy() - np.asarray(want_o))) \
            <= OUT_TOL, name
        assert np.max(np.abs(lse.detach().numpy()
                             - np.asarray(want_lse))) <= OUT_TOL, name
        for g_name, t, jg in zip("qkv", leaves, jgrads):
            err = np.max(np.abs(t.grad.numpy() - np.asarray(jg)))
            assert err <= GRAD_TOL, (name, g_name, err)


def test_flash_with_lse_layouts_and_launches():
    # BTHD gives the BHTD result in its own layout; the CPU route counts
    # no launch; each output alone carries a gradient
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 20, 16),
                                                    np.float32))
               for _ in range(3))
    kernels.reset_launch_counts()
    o, lse = kernels.maybe_flash_attention_with_lse(q, k, v, causal=True)
    ot, lset = kernels.maybe_flash_attention_with_lse(
        *(x.transpose(1, 2) for x in (q, k, v)), causal=True,
        layout="bthd")
    assert torch.allclose(ot.transpose(1, 2), o, atol=1e-6)
    assert torch.allclose(lset, lse, atol=1e-6)
    assert all(n == 0 for n in kernels.launch_counts().values())
    for pick in (0, 1):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(fa.flash_attention_with_lse(
            *leaves, causal=True, kernels=fa.PLAIN_KERNELS)[pick].sum(),
            leaves)
        ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        # lse does not reach v: its gradient there is exactly 0
        want = torch.autograd.grad(fa.flash_attention_with_lse_plain(
            *ref_leaves, causal=True)[pick].sum(), ref_leaves,
            allow_unused=True, materialize_grads=True)
        for a, e in zip(got, want):
            assert float((a - e).abs().max()) <= GRAD_TOL, pick
