"""PyTorch port: the split-KV decomposition of the paged decode kernel.

The single-query CUDA kernel (``csrc/paged_attention.cu``) cuts each
sequence's context into chunks of ``CHUNK_TOKENS`` tokens, forms a
softmax partial (m, l, acc) per chunk and merges the partials in chunk
order. ``paged_attention_split_plain`` is that decomposition in plain
PyTorch for any chunk size. Here it is held against the JAX package's
``paged_attention`` (the Pallas kernel in interpret mode) on lens at the
chunk edges, for several chunk sizes, one smaller than a KV block; the
kernel itself is held against it on the card by ``chip_smoke.py``. The
design A/Bs of ``kernels/design_ab.py`` are checked to still apply to
the kernels' sources.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention)

from paddle_tpu_torch.kernels import _build, design_ab  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402

# fp32 sums in another order than the Pallas kernel's (block by block)
TOL = 2e-6
BLOCK = 16


def _paged(lens, h=2, d=32, seed=0, garbage=False):
    """Ragged block tables over a shuffled pool; entries past each
    sequence's blocks are 0, or with ``garbage`` out-of-pool and negative
    junk."""
    rng = np.random.RandomState(seed)
    nb = [-(-n // BLOCK) for n in lens]
    n_blocks = sum(nb) + 3
    maxb = max(nb) + 2
    q = rng.randn(len(lens), h, d).astype(np.float32)
    kp = rng.randn(n_blocks, BLOCK, h, d).astype(np.float32)
    vp = rng.randn(n_blocks, BLOCK, h, d).astype(np.float32)
    perm = rng.permutation(n_blocks)
    if garbage:
        tbl = rng.randint(-9, n_blocks + 9, size=(len(lens), maxb))
    else:
        tbl = np.zeros((len(lens), maxb))
    tbl = tbl.astype(np.int32)
    off = 0
    for i, k in enumerate(nb):
        tbl[i, :k] = perm[off:off + k]
        off += k
    return q, kp, vp, tbl, np.asarray(lens, np.int32)


def _edge_lens(chunk):
    """A chunk exactly, one token past it, one short of it, a single
    token, and two chunks and a few tokens."""
    return sorted({chunk, chunk + 1, max(chunk - 1, 1), 1, 2 * chunk + 3})


# chunk sizes: below a KV block (8), one block (16), not a multiple of
# the block (48), and the kernel's own
@pytest.mark.parametrize("chunk", [8, BLOCK, 48, pa.CHUNK_TOKENS])
def test_split_plain_matches_jax_kernel_at_chunk_edges(chunk):
    arrs = _paged(_edge_lens(chunk), seed=chunk)
    want = np.asarray(jax_paged_attention(*arrs, interpret=True))
    got = pa.paged_attention_split_plain(
        *(torch.from_numpy(a) for a in arrs), chunk_tokens=chunk)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) <= TOL


@pytest.mark.parametrize("chunk", [8, pa.CHUNK_TOKENS])
def test_split_plain_ignores_garbage_table_entries(chunk):
    lens = _edge_lens(chunk)
    clean = _paged(lens, seed=3)
    junk = _paged(lens, seed=3, garbage=True)
    assert not np.array_equal(clean[3], junk[3])
    want = np.asarray(jax_paged_attention(*junk, interpret=True))
    a = pa.paged_attention_split_plain(
        *(torch.from_numpy(x) for x in clean), chunk_tokens=chunk)
    b = pa.paged_attention_split_plain(
        *(torch.from_numpy(x) for x in junk), chunk_tokens=chunk)
    assert torch.equal(a, b)
    assert np.max(np.abs(b.numpy() - want)) <= TOL


def test_split_plain_scale_and_chunk_count_do_not_change_the_function():
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged(
        [1, 40, 97], h=3, d=16, seed=5))
    want = np.asarray(jax_paged_attention(
        *(x.numpy() for x in (q, kp, vp, tbl, lens)), scale=0.3,
        interpret=True))
    outs = [pa.paged_attention_split_plain(q, kp, vp, tbl, lens, 0.3, c)
            for c in (1, 7, 32, 1000)]
    for o in outs:
        assert np.max(np.abs(o.numpy() - want)) <= TOL
    assert torch.allclose(outs[0], pa.paged_attention_plain(
        q, kp, vp, tbl, lens, 0.3), atol=TOL, rtol=0)


def test_split_plain_empty_row_gives_zero_and_clamps_to_the_table():
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged(
        [0, 20, 33], seed=7))
    out = pa.paged_attention_split_plain(q, kp, vp, tbl, lens,
                                         chunk_tokens=8)
    # an empty row gives 0 (acc / max(l, 1e-30)), as the kernels do
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    # a context past what the table addresses reads only the table's
    # blocks: the same as the context clamped to them
    cap = tbl.shape[1] * BLOCK
    longer = pa.paged_attention_split_plain(
        q, kp, vp, tbl, torch.tensor([0, 20, cap + 50], dtype=torch.int32),
        chunk_tokens=8)
    clamped = pa.paged_attention_split_plain(
        q, kp, vp, tbl, torch.tensor([0, 20, cap], dtype=torch.int32),
        chunk_tokens=8)
    assert torch.equal(longer, clamped)


def test_chunk_is_the_kernels_and_positive_chunks_only():
    # the C entry takes exactly its own chunk, 4 warps' 32-token tiles
    src = (_build.CSRC / "paged_attention.cu").read_text()
    assert "constexpr int kSplitWarps = 4;" in src
    assert "constexpr int kTile = 32;" in src
    assert "chunk != kChunk" in src
    assert pa.CHUNK_TOKENS == 4 * 32
    q, kp, vp, tbl, lens = (torch.from_numpy(a) for a in _paged([5]))
    with pytest.raises(ValueError, match="chunk_tokens"):
        pa.paged_attention_split_plain(q, kp, vp, tbl, lens,
                                       chunk_tokens=0)


@pytest.mark.parametrize("exp,variant", [
    (e, v) for e, spec in design_ab.EXPERIMENTS.items()
    for v in spec["variants"]])
def test_design_ab_variants_apply_to_the_current_sources(exp, variant):
    # the design A/Bs PERF.md reports patch the kernels as they stand:
    # every substitution still matches its source exactly once
    spec = design_ab.EXPERIMENTS[exp]
    src = (_build.CSRC / f"{spec['library']}.cu").read_text()
    got = design_ab.patched(spec["library"], spec["variants"][variant])
    assert got != src
