"""PyTorch port: the 3xTF32 arithmetic of the tensor-core kernels.

The xent kernels and the flash dK/dV kernel (``csrc/tf32_mma.cuh``)
split each fp32 operand into two TF32 numbers (``hi = rna(x)``, ``lo =
rna(x - hi)``, ``cvt.rna.tf32.f32``'s rounding: to nearest, ties away
from zero) and sum ``lo.hi + hi.lo + hi.hi`` in fp32, a stage of the
reduction per fresh tile. Here a plain emulation of that scheme is held
against float64 products of the same numpy inputs at the reduction
lengths of the kernels' main-path calls: K = 768 (the xent logits over
BERT-base's hidden size) and K = 64 and 512 (the dK/dV kernel's S^T and
dP^T over a head dim; dV and dK over a query tile). This checks the
scheme, not the kernels: ``round_tf32`` is a copy of the header's
rounding, and the kernels' accuracy is held on the card by
``chip_smoke.py``'s ``XENT_TOL`` and ``FLASH_GRAD_TOL`` checks against
their plain versions.
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


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor,
                  stage: int) -> torch.Tensor:
    """a @ b with lo.hi + hi.lo + hi.hi per stage of ``stage`` reduction
    columns in a fresh fp32 tile, the stages added in order (the products
    of two TF32 numbers are exact in fp32)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    out = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], stage):
        k = slice(k0, k0 + stage)
        out += al[:, k] @ bh[k] + ah[:, k] @ bl[k] + ah[:, k] @ bh[k]
    return out


# hi + lo reconstructs x within 2^-22 relatively: x - hi is exact, and
# rounding it to TF32 (11 significant bits) loses at most 2^-11 of it,
# which is at most 2^-11 of x
SPLIT_TOL = 2.0 ** -22
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
