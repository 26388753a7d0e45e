"""PyTorch port: the split-KV decomposition of the multi-query verify
kernel.

The verify window's CUDA kernel (``csrc/paged_attention.cu``) cuts each
sequence's context into chunks of ``CHUNK_TOKENS`` tokens, takes the
window's rows in groups of ``ROW_GROUP`` over each chunk's K/V tiles,
forms a softmax partial (m, l, acc) per (row, chunk) with each row's own
causal limit, and merges the partials in chunk order.
``paged_attention_multiquery_split_plain`` is that decomposition in plain
PyTorch for any chunk size and row group. Here it is held against the JAX
package's ``paged_attention_multiquery`` (the Pallas kernel in interpret
mode) on windows that straddle chunk edges, windows as long as their
context, padded rows, chunks wholly past some rows' limits and windows
wider than a row group, each with garbage table entries past the
sequence; the kernel itself is held against it on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention_multiquery as jax_paged_attention_mq)

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402

# fp32 sums in another order than the Pallas kernel's (block by block)
TOL = 2e-6
BLOCK = 16


def _window(lens, qlens, qmax, h=2, d=32, seed=0):
    """q [B, qmax, h, d] windows over ragged block tables on a shuffled
    pool, with out-of-pool and negative junk in the table entries past
    each sequence's blocks; numpy arrays in the JAX argument order."""
    rng = np.random.RandomState(seed)
    nb = [-(-n // BLOCK) for n in lens]
    n_blocks = sum(nb) + 3
    maxb = max(nb) + 2
    q = rng.randn(len(lens), qmax, h, d).astype(np.float32)
    kp = rng.randn(n_blocks, BLOCK, h, d).astype(np.float32)
    vp = rng.randn(n_blocks, BLOCK, h, d).astype(np.float32)
    perm = rng.permutation(n_blocks)
    tbl = rng.randint(-9, n_blocks + 9, size=(len(lens), maxb)).astype(
        np.int32)
    off = 0
    for i, k in enumerate(nb):
        tbl[i, :k] = perm[off:off + k]
        off += k
    return (q, np.asarray(qlens, np.int32), kp, vp, tbl,
            np.asarray(lens, np.int32))


def _check(arrs, chunk, row_group=pa.ROW_GROUP, scale=None):
    want = np.asarray(jax_paged_attention_mq(*arrs, scale=scale,
                                             interpret=True))
    got = pa.paged_attention_multiquery_split_plain(
        *(torch.from_numpy(a) for a in arrs), scale, chunk, row_group)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    # padded rows attend the whole context in both: compared too
    assert np.max(np.abs(got.numpy() - want)) <= TOL
    return got


def _cases(chunk):
    """(lens, qlens, qmax) at a chunk size: windows straddling a chunk
    edge (rows before the edge see a last chunk wholly past their
    limits), a window as long as its context, padded rows, a window of
    one row among wider ones, and a long context."""
    c = chunk
    return [
        ([c + 1, c + 2, c + 3, c, 2 * c + 1], [4, 4, 4, 4, 3], 4),
        ([4, 3, 2 * c + 2, 1], [4, 3, 2, 1], 4),
        ([c + 1, 3 * c + 5, 9], [1, 2, 3], 4),
    ]


# chunk sizes: below a KV block (8), one block (16), not a multiple of
# the block (48), and the kernel's own
@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("chunk", [8, BLOCK, 48, pa.CHUNK_TOKENS])
def test_verify_split_plain_matches_jax_kernel(chunk, case):
    lens, qlens, qmax = _cases(chunk)[case]
    _check(_window(lens, qlens, qmax, seed=chunk + case), chunk)


@pytest.mark.parametrize("row_group", [1, 4, 5])
def test_window_wider_than_a_row_group(row_group):
    # Qmax 9: three groups of 4 (the kernel's), or 9 of 1, or 5 + 4; a
    # window of 9 straddling the chunk edge, padded rows, a 9-token
    # context
    arrs = _window([9, 130, 300, 20, 257], [9, 9, 5, 1, 7], 9, seed=9)
    _check(arrs, pa.CHUNK_TOKENS, row_group)


def test_row_group_and_chunk_do_not_change_the_function():
    arrs = _window([5, 40, 97, 129], [4, 2, 4, 3], 4, h=3, d=16, seed=5)
    outs = [_check(arrs, c, g, scale=0.3)
            for c, g in ((1, 1), (7, 2), (32, 4), (1000, 8))]
    for o in outs[1:]:
        assert torch.allclose(o, outs[0], atol=TOL, rtol=0)
    plain = pa.paged_attention_multiquery_plain(
        *(torch.from_numpy(a) for a in arrs), 0.3)
    assert torch.allclose(outs[0], plain, atol=TOL, rtol=0)


def test_garbage_table_entries_do_not_change_the_output():
    lens, qlens = [129, 4, 260], [4, 4, 3]
    junk = _window(lens, qlens, 4, seed=3)
    clean = list(junk)
    tbl = junk[4].copy()
    for i, n in enumerate(lens):
        tbl[i, -(-n // BLOCK):] = 0
    clean[4] = tbl
    assert not np.array_equal(clean[4], junk[4])
    a, b = (pa.paged_attention_multiquery_split_plain(
        *(torch.from_numpy(x) for x in arrs)) for arrs in (clean, junk))
    assert torch.equal(a, b)


def test_chunk_past_a_rows_limit_is_an_exact_empty_partial():
    # ctx 129, a window of 4 at positions 125..128 with chunks of 128:
    # rows 0-2 see nothing of chunk 1, row 3 sees its one token. Whatever
    # that token's K and V hold, rows 0-2 stay bit for bit the same (their
    # chunk-1 partial is exactly empty), and row 3 moves
    q, ql, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _window(
        [129], [4], 4, seed=11))
    got = pa.paged_attention_multiquery_split_plain(q, ql, kp, vp, tbl,
                                                    lens)
    kp2, vp2 = kp.clone(), vp.clone()
    blk = int(tbl[0, 128 // BLOCK])
    kp2[blk, 0] = 50.0
    vp2[blk, 0] = -1e3
    moved = pa.paged_attention_multiquery_split_plain(q, ql, kp2, vp2, tbl,
                                                      lens)
    assert torch.equal(got[:, :3], moved[:, :3])
    assert not torch.allclose(got[:, 3], moved[:, 3])


def test_qmax1_is_the_single_query_decomposition():
    q, ql, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _window(
        [1, 40, 300], [1, 1, 1], 1, seed=2))
    got = pa.paged_attention_multiquery_split_plain(q, ql, kp, vp, tbl,
                                                    lens)
    single = pa.paged_attention_split_plain(q[:, 0], kp, vp, tbl, lens)
    assert torch.equal(got[:, 0], single)


def test_row_group_is_the_kernels_and_positive_only():
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert f"constexpr int kRowGroup = {pa.ROW_GROUP};" in src
    arrs = [torch.from_numpy(a) for a in _window([5], [2], 2)]
    with pytest.raises(ValueError, match="row_group"):
        pa.paged_attention_multiquery_split_plain(*arrs, row_group=0)
