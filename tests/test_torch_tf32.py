"""PyTorch port: the 3xTF32 arithmetic of the tensor-core kernels.

The xent kernels and the flash forward, dq and dK/dV kernels
(``csrc/tf32_mma.cuh``)
split each fp32 operand into two TF32 numbers (``hi = rna(x)``, ``lo =
rna(x - hi)``, ``cvt.rna.tf32.f32``'s rounding: to nearest, ties away
from torch_threads import port_threads  # noqa: F401  (autouse fixture)
from zero) and sum ``lo.hi + hi.lo + hi.hi`` in fp32, a stage of the
reduction per fresh tile. Here a plain emulation of that scheme is held
against float64 products of the same numpy inputs at the reduction
lengths of the kernels' main-path calls: K = 768 (the xent logits over
BERT-base's hidden size) and K = 64 and 512 (the dK/dV kernel's S^T and
dP^T over a head dim; dV and dK over a query tile). Then the flash
forward's and dq's tile arithmetic as a whole (3xTF32 products by key
tile, the online softmax, fresh tiles) is emulated and held against the
JAX flash kernel in interpret mode at [1, 2, 512, 64], and so is the
fused backward's (16-key sub-tiles, dQ summed over the scan, dK and dV
by 32-query fresh tiles, the fast split that passes lo unrounded) at
[1, 2, 128, 64], against the JAX backward on its fused route. This
checks the scheme, not the kernels: ``round_tf32`` is a copy of the
header's rounding, and the kernels' accuracy is held on the card by
``chip_smoke.py``'s ``XENT_TOL``, ``FLASH_TOL`` and ``FLASH_GRAD_TOL``
checks against their plain versions.
"""

import numpy as np
import pytest
import torch

_M32 = 0xFFFFFFFF


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """rna of fp32 ``x`` as tf32_mma.cuh computes it: half of the dropped
    13 bits' weight added to the magnitude's bit pattern, then the 13 bits
    cleared (a carry moves into the exponent)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits & _M32) + (1 << 12)) & (_M32 ^ ((1 << 13) - 1))
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 value passed as a tf32
    operand: the low 13 mantissa bits dropped (truncation)."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~((1 << 13) - 1)).view(torch.float32)


def split_tf32_fast(x: torch.Tensor):
    """tf32::split<true>: hi rounded as split_tf32's, lo = x - hi passed
    unrounded, so the tensor cores truncate it."""
    hi = round_tf32(x)
    return hi, trunc_tf32(x.float() - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, stage: int,
                  split=split_tf32) -> torch.Tensor:
    """a @ b with lo.hi + hi.lo + hi.hi per stage of ``stage`` reduction
    columns in a fresh fp32 tile, the stages added in order (the products
    of two TF32 numbers are exact in fp32). ``split``: split_tf32 or
    split_tf32_fast."""
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], stage):
        k = slice(k0, k0 + stage)
        out += al[:, k] @ bh[k] + ah[:, k] @ bl[k] + ah[:, k] @ bh[k]
    return out


# hi + lo reconstructs x within 2^-22 relatively: x - hi is exact, and
# rounding it to TF32 (11 significant bits) loses at most 2^-11 of it,
# which is at most 2^-11 of x
SPLIT_TOL = 2.0 ** -22
# the fast split: lo = x - hi is exact and at most 2^-11 of x; the tensor
# cores keep its top 11 significant bits, dropping less than 2^-10 of it
FAST_SPLIT_TOL = 2.0 ** -21
# a 3-pass product against float64, relative to the largest entry: the
# exact TF32 products leave only lo.lo (2^-22) and the fp32 sums; an fp32
# matmul of the same inputs errs by ~5e-7 there, one TF32 pass by ~3e-4
PRODUCT_TOL = 2e-6


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5e4, 1e30])
def test_split_reconstructs_within_2_to_minus_22(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = torch.from_numpy((scale * rng.standard_normal(4096)).astype(
        np.float32))
    hi, lo = split_tf32(x)
    for t in (hi, lo):  # TF32 values: the low 13 mantissa bits are 0
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(err) <= SPLIT_TOL


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.5e4, 1e30])
def test_fast_split_reconstructs_within_2_to_minus_21(scale):
    rng = np.random.default_rng(int(np.log10(scale)) + 80)
    x = torch.from_numpy((scale * rng.standard_normal(4096)).astype(
        np.float32))
    hi, lo = split_tf32_fast(x)
    for t in (hi, lo):  # what the tensor cores read: TF32 values
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    err = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(err) <= FAST_SPLIT_TOL


def test_rna_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # of TF32 at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0]
    assert round_tf32(x).tolist() == want


# (M, K, N, stage): the xent forward's logits (64-deep stages), the dK/dV
# kernel's S^T over a head dim of 64 and of 512 (32-deep stages)
@pytest.mark.parametrize("m,k,n,stage", [(64, 768, 128, 64),
                                         (64, 64, 64, 32),
                                         (64, 512, 64, 32)])
def test_three_pass_product_matches_fp32(m, k, n, stage):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(want).max()
    got = matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b), stage)
    err = np.abs(got.double().numpy() - want).max() / scale
    assert err <= PRODUCT_TOL
    # one pass (plain TF32) is not fp32: the split is what keeps accuracy
    one = round_tf32(torch.from_numpy(a)) @ round_tf32(
        torch.from_numpy(b))
    assert np.abs(one.double().numpy() - want).max() / scale > 50 * err


# (M, K, N, stage) of the fused flash backward's products: S and dP over a
# head dim of 64, dK and dV over 128 queries (32-deep fresh tiles)
@pytest.mark.parametrize("m,k,n,stage", [(64, 64, 64, 32),
                                         (64, 128, 64, 32)])
def test_fast_three_pass_product_matches_fp32(m, k, n, stage):
    rng = np.random.default_rng(k + 1)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(want).max()
    got = matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b), stage,
                        split_tf32_fast)
    err = np.abs(got.double().numpy() - want).max() / scale
    assert err <= PRODUCT_TOL
    one = round_tf32(torch.from_numpy(a)) @ round_tf32(
        torch.from_numpy(b))
    assert np.abs(one.double().numpy() - want).max() / scale > 50 * err


# --- the flash forward's and dq's tile arithmetic -------------------------
#
# The forward and dq kernels (D <= 128) run each key tile of BK = 32 keys
# as 3xTF32 products: S = (q scale) K^T over the head dim in stages of 32
# columns, each into a fresh tile added in fp32; the online softmax by key
# tile (m, l, alpha; l sums the undropped p); O = O alpha + (P V over the
# tile's keys, a fresh tile). dq: S and dP = dO V^T likewise, dS = p (dP
# keep / (1 - p) - delta) scale, dQ += (dS K, a fresh tile). The emulation
# below repeats that arithmetic in plain PyTorch (the tensor cores' own
# sums, not rounded to nearest, are not emulated: fp32 sums stand in) and
# is held against the JAX flash kernel in interpret mode.

FLASH_TOL = 2e-5
FLASH_GRAD_TOL = 5e-5
TILE_KEYS = 32
HEAD_STAGE = 32


def _scores(a, b):
    """a @ b^T in stages of HEAD_STAGE head-dim columns, 3xTF32."""
    return matmul_3xtf32(a, b.T, HEAD_STAGE)


def emulate_fwd(q, k, v, scale, causal=False, keep=None, p_drop=0.0):
    """(out, lse) of one head, [T, D] operands, by key tiles."""
    tq, tk = q.shape[0], k.shape[0]
    qs = q * scale
    m = torch.full((tq, 1), -1e30)
    l = torch.zeros(tq, 1)
    o = torch.zeros(tq, q.shape[1])
    rows = torch.arange(tq)[:, None]
    for k0 in range(0, tk, TILE_KEYS):
        kt, vt = k[k0:k0 + TILE_KEYS], v[k0:k0 + TILE_KEYS]
        cols = torch.arange(k0, k0 + kt.shape[0])[None, :]
        vis = torch.ones(tq, kt.shape[0], dtype=torch.bool)
        if causal:
            vis = rows + (tk - tq) >= cols
        s = torch.where(vis, _scores(qs, kt), torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new), torch.tensor(0.0))
        l = l * alpha + p.sum(dim=1, keepdim=True)
        m = m_new
        if keep is not None:
            p = torch.where(keep[:, k0:k0 + kt.shape[0]], p,
                            torch.tensor(0.0))
        o = o * alpha + matmul_3xtf32(p, vt, TILE_KEYS)
    safe_l = l.clamp_min(1e-30)
    out = o / safe_l
    if keep is not None:
        out = out / (1.0 - p_drop)
    return out, (m + torch.log(safe_l))[:, 0]


def emulate_dq(q, k, v, dout, lse, delta, scale, causal=False, keep=None,
               p_drop=0.0):
    """dq of one head from the saved lse and delta, by key tiles."""
    tq, tk = q.shape[0], k.shape[0]
    dq = torch.zeros_like(q)
    rows = torch.arange(tq)[:, None]
    for k0 in range(0, tk, TILE_KEYS):
        kt, vt = k[k0:k0 + TILE_KEYS], v[k0:k0 + TILE_KEYS]
        cols = torch.arange(k0, k0 + kt.shape[0])[None, :]
        p = torch.exp(_scores(q, kt) * scale - lse[:, None])
        if causal:
            p = torch.where(rows + (tk - tq) >= cols, p, torch.tensor(0.0))
        dp = _scores(dout, vt)
        if keep is not None:
            dp = torch.where(keep[:, k0:k0 + kt.shape[0]],
                             dp / (1.0 - p_drop), torch.tensor(0.0))
        ds = p * (dp - delta[:, None]) * scale
        dq = dq + matmul_3xtf32(ds, kt, TILE_KEYS)
    return dq


@pytest.mark.parametrize("causal,p_drop", [(False, 0.0), (True, 0.1)])
def test_flash_tile_emulation_matches_jax(causal, p_drop):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.kernels import flash_attention as jax_fa
    from paddle_tpu_torch.kernels.flash_attention import dropout_keep_mask

    b, h, t, d, seed = 1, 2, 512, 64, 77
    rng = np.random.default_rng(d + int(causal))
    q, k, v, ct = (rng.standard_normal((b, h, t, d)).astype(np.float32)
                   for _ in range(4))
    out, vjp = jax.vjp(lambda q_: jax_fa.flash_attention(
        q_, jnp.asarray(k), jnp.asarray(v), causal, None, True, p_drop,
        jnp.int32(seed) if p_drop else None), jnp.asarray(q))
    (jdq,) = vjp(jnp.asarray(ct))
    keep = dropout_keep_mask(torch.tensor([seed], dtype=torch.int32), b, h,
                             t, t, p_drop) if p_drop else None
    scale = 1.0 / np.sqrt(d)
    for g in range(b * h):
        args = [torch.from_numpy(x[0, g]) for x in (q, k, v)]
        kg = None if keep is None else keep[0, g]
        o, lse = emulate_fwd(*args, scale, causal, kg, p_drop)
        err = float(np.max(np.abs(o.numpy() - np.asarray(out[0, g]))))
        assert err <= FLASH_TOL, ("out", g, err)
        dout = torch.from_numpy(ct[0, g])
        delta = (dout * o).sum(dim=1)
        dq = emulate_dq(*args, dout, lse, delta, scale, causal, kg, p_drop)
        err = float(np.max(np.abs(dq.numpy() - np.asarray(jdq[0, g]))))
        assert err <= FLASH_GRAD_TOL, ("dq", g, err)


# --- the fused backward's sub-tile arithmetic -----------------------------
#
# The fused backward kernel holds one (batch, head) whole and scans key
# sub-tiles of FUSED_KEYS keys. Per sub-tile: S = Q K^T and dP = dO V^T
# (3xTF32, the fast split, stages of 32 head-dim columns in fresh tiles),
# p = exp(s scale + bias - lse) (0 where masked), Pv = p keep / (1 - p),
# dS = p (dP keep / (1 - p) - delta) scale; dQ += dS K (a fresh tile per
# sub-tile, added over the scan); the sub-tile's dV = Pv^T dO and dK =
# dS^T Q over the query rows from qlo (causal: the first 16-row warp that
# sees the sub-tile) in fresh tiles of 32 rows. Emulated below and held
# against the JAX backward on its fused route (both sequences within one
# tile) in interpret mode.

FUSED_KEYS = 16
FUSED_QUERY_STAGE = 32


def _fast(a, b, stage):
    return matmul_3xtf32(a, b, stage, split_tf32_fast)


def emulate_fused_bwd(q, k, v, dout, lse, delta, scale, causal=False,
                      keep=None, p_drop=0.0, bias=None):
    """(dq, dk, dv) of one head, [T, D] operands, by key sub-tiles."""
    tq, tk = q.shape[0], k.shape[0]
    off = tk - tq
    inv_keep = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        1.0 - p_drop, dtype=torch.float32)
    dq = torch.zeros_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    rows = torch.arange(tq)[:, None]
    for k0 in range(0, tk, FUSED_KEYS):
        kt, vt = k[k0:k0 + FUSED_KEYS], v[k0:k0 + FUSED_KEYS]
        n = kt.shape[0]
        cols = torch.arange(k0, k0 + n)[None, :]
        s = _fast(q, kt.T, HEAD_STAGE) * scale
        if bias is not None:
            s = s + bias[k0:k0 + n][None, :]
        p = torch.exp(s - lse[:, None])
        if causal:
            p = torch.where(rows + off >= cols, p, torch.tensor(0.0))
        dp = _fast(dout, vt.T, HEAD_STAGE)
        pv = p
        if keep is not None:
            kk = keep[:, k0:k0 + n]
            pv = torch.where(kk, p * inv_keep, torch.tensor(0.0))
            dp = torch.where(kk, dp * inv_keep, torch.tensor(0.0))
        ds = p * (dp - delta[:, None]) * scale
        dq = dq + _fast(ds, kt, FUSED_KEYS)
        qlo = max(0, (k0 - off) // 16 * 16) if causal else 0
        for c0 in range(qlo, tq, FUSED_QUERY_STAGE):
            c = slice(c0, c0 + FUSED_QUERY_STAGE)
            dv[k0:k0 + n] += _fast(pv[c].T, dout[c], FUSED_QUERY_STAGE)
            dk[k0:k0 + n] += _fast(ds[c].T, q[c], FUSED_QUERY_STAGE)
    return dq, dk, dv


# (causal, dropout p, key bias): unmasked and causal, with and without
# dropout, a key bias in one case
@pytest.mark.parametrize("causal,p_drop,with_bias", [
    (False, 0.0, False), (True, 0.0, False), (False, 0.1, True),
    (True, 0.1, False)])
def test_fused_bwd_tile_emulation_matches_jax(causal, p_drop, with_bias):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from paddle_tpu.kernels import flash_attention as jax_fa
    from paddle_tpu_torch.kernels.flash_attention import (
        dropout_keep_mask, flash_attention_plain)

    b, h, t, d, seed = 1, 2, 128, 64, 91
    rng = np.random.default_rng(d + 2 * int(causal) + int(with_bias))
    q, k, v, ct = (rng.standard_normal((b, h, t, d)).astype(np.float32)
                   for _ in range(4))
    bias = None
    if with_bias:
        bias = np.where(rng.random((b, t)) < 0.85, 0.0,
                        np.finfo(np.float32).min).astype(np.float32)
        bias[:, 0] = 0.0
    jseed = jnp.int32(seed) if p_drop else None
    jbias = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_fa.flash_attention(
        q_, k_, v_, causal, None, True, p_drop, jseed, jbias),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(ct))
    tseed = torch.tensor([seed], dtype=torch.int32)
    keep = dropout_keep_mask(tseed, b, h, t, t, p_drop) if p_drop else None
    tbias = None if bias is None else torch.from_numpy(bias)
    # the forward's out and lse, from which the backward's delta comes
    out, lse = flash_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, None, p_drop,
        tseed if p_drop else None, tbias, return_lse=True)
    scale = 1.0 / np.sqrt(d)
    for g in range(b * h):
        args = [torch.from_numpy(x[0, g]) for x in (q, k, v)]
        dout = torch.from_numpy(ct[0, g])
        delta = (dout * out[0, g]).sum(dim=1)
        grads = emulate_fused_bwd(
            *args, dout, lse[0, g], delta, scale, causal,
            None if keep is None else keep[0, g], p_drop,
            None if tbias is None else tbias[0])
        for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
            err = float(np.max(np.abs(got.numpy()
                                      - np.asarray(want[0, g]))))
            assert err <= FLASH_GRAD_TOL, (name, g, err)
