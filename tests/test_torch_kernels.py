"""PyTorch port: the kernels' plain versions against the JAX kernels.

The CUDA kernels themselves run only on a GPU (``python3 chip_smoke.py``
holds them against these plain versions there). Here, on the CPU, the
plain versions are held against the Pallas kernels in interpret mode,
on the same numpy inputs, and the host side of the kernels (routing,
launch counters, the ctypes binding, the build's refusal to fall back)
is checked.
"""

from torch_threads import port_threads  # noqa: F401  (autouse fixture)
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from paddle_tpu.kernels.layer_norm import layer_norm_pallas  # noqa: E402
from paddle_tpu.kernels.paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
    paged_attention_multiquery as jax_paged_attention_mq)

from paddle_tpu_torch import kernels  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import layer_norm as ln  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as pa  # noqa: E402


def _paged(b, qmax, h, d, n_blocks, bs, lens, qlens=None, seed=0):
    """Same construction as the JAX suite: ragged block tables over a
    shuffled pool; unused table entries are 0."""
    rng = np.random.RandomState(seed)
    q_shape = (b, h, d) if qmax is None else (b, qmax, h, d)
    q = rng.randn(*q_shape).astype(np.float32)
    kp = rng.randn(n_blocks, bs, h, d).astype(np.float32)
    vp = rng.randn(n_blocks, bs, h, d).astype(np.float32)
    perm = rng.permutation(n_blocks)
    maxb = -(-max(lens) // bs)
    tbl = np.zeros((b, maxb), np.int32)
    off = 0
    for i, ln_ in enumerate(lens):
        nb = -(-ln_ // bs)
        tbl[i, :nb] = perm[off:off + nb]
        off += nb
    arrs = [q, kp, vp, tbl, np.asarray(lens, np.int32)]
    if qlens is not None:
        arrs.append(np.asarray(qlens, np.int32))
    return arrs


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


class TestPagedAttentionPlain:
    # ragged lens of the JAX suite (tests/test_serving_llm.py)
    @pytest.mark.parametrize("lens", [[1], [17, 80, 5, 32], [33, 1, 64]])
    def test_matches_jax_kernel(self, lens):
        q, kp, vp, tbl, ln_ = _paged(len(lens), None, 4, 32, 48, 16, lens)
        want = np.asarray(jax_paged_attention(q, kp, vp, tbl, ln_,
                                              interpret=True))
        got = kernels.maybe_paged_attention(*_t(q, kp, vp, tbl, ln_))
        assert np.max(np.abs(got.numpy() - want)) <= 2e-6

    def test_scale_override(self):
        q, kp, vp, tbl, ln_ = _paged(2, None, 2, 16, 8, 8, [9, 3], seed=1)
        want = np.asarray(jax_paged_attention(q, kp, vp, tbl, ln_,
                                              scale=0.5, interpret=True))
        got = kernels.maybe_paged_attention(*_t(q, kp, vp, tbl, ln_),
                                            scale=0.5)
        assert np.max(np.abs(got.numpy() - want)) <= 2e-6

    def test_garbage_table_entries_past_context_are_ignored(self):
        q, kp, vp, tbl, ln_ = _paged(3, None, 2, 16, 24, 4, [5, 12, 1],
                                     seed=5)
        want = kernels.maybe_paged_attention(*_t(q, kp, vp, tbl, ln_))
        junk = tbl.copy()
        for i, n in enumerate([5, 12, 1]):
            junk[i, -(-n // 4):] = [-7, 99, 3][i]
        got = kernels.maybe_paged_attention(*_t(q, kp, vp, junk, ln_))
        assert torch.equal(got, want)


class TestMultiQueryPlain:
    @pytest.mark.parametrize("lens,qlens", [
        ([17, 80, 5, 32], [3, 4, 1, 2]),
        ([33, 4, 64], [2, 4, 1]),
        ([3], [3]),
    ])
    def test_matches_jax_kernel(self, lens, qlens):
        q, kp, vp, tbl, ln_, ql = _paged(len(lens), max(qlens), 4, 32, 48,
                                         16, lens, qlens)
        want = np.asarray(jax_paged_attention_mq(q, ql, kp, vp, tbl, ln_,
                                                 interpret=True))
        got = kernels.maybe_paged_attention_multiquery(
            *_t(q, ql, kp, vp, tbl, ln_)).numpy()
        assert np.isfinite(got).all()
        # padded rows attend the whole context in both: compare them too
        assert np.max(np.abs(got - want)) <= 2e-6

    def test_qmax1_is_bitwise_single_query(self):
        q, kp, vp, tbl, ln_, ql = _paged(3, 1, 4, 32, 16, 8, [9, 17, 32],
                                         [1, 1, 1], seed=2)
        got = kernels.maybe_paged_attention_multiquery(
            *_t(q, ql, kp, vp, tbl, ln_))
        want = kernels.maybe_paged_attention(*_t(q[:, 0], kp, vp, tbl,
                                                 ln_))
        assert torch.equal(got[:, 0], want)

    def test_padded_single_row_matches_single_query(self):
        q, kp, vp, tbl, ln_, ql = _paged(2, 3, 2, 16, 12, 8, [9, 20],
                                         [1, 3], seed=4)
        got = kernels.maybe_paged_attention_multiquery(
            *_t(q, ql, kp, vp, tbl, ln_))
        single = kernels.maybe_paged_attention(
            *_t(np.ascontiguousarray(q[:, 0]), kp, vp, tbl, ln_))
        assert float((got[0, 0] - single[0]).abs().max()) <= 2e-6
        assert torch.isfinite(got).all()


class TestLayerNormPlain:
    # the last two: the warp-per-row kernel's register cap (1024 columns)
    # and a row above it (the block-per-row kernel's)
    @pytest.mark.parametrize("rows,cols", [(16, 128), (8, 256), (8, 1024),
                                           (16, 4096)])
    def test_matches_jax_kernel(self, rows, cols):
        rng = np.random.RandomState(7)
        x = rng.randn(rows, cols).astype(np.float32)
        w = (1 + 0.1 * rng.randn(cols)).astype(np.float32)
        b = (0.1 * rng.randn(cols)).astype(np.float32)
        want = np.asarray(layer_norm_pallas(x, w, b, 1e-5, interpret=True))
        got = kernels.maybe_layer_norm(*_t(x, w, b), 1e-5, 1)
        assert np.max(np.abs(got.numpy() - want)) <= 1e-5
        assert torch.equal(ln.layer_norm_plain(*_t(x, w, b), 1e-5), got)

    def test_unaligned_shapes_route_without_a_gate(self):
        # the JAX kernel refuses cols % 128 != 0 and rows < 8 (a TPU
        # tiling limit); the port's route takes every shape
        x = torch.randn(3, 5, 50)
        w, b = torch.ones(50), torch.zeros(50)
        got = kernels.maybe_layer_norm(x, w, b, 1e-5, 2)
        want = torch.nn.functional.layer_norm(x, (50,), w, b, 1e-5)
        assert float((got - want).abs().max()) <= 1e-5


class TestRoutingAndCounters:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        kernels.reset_launch_counts()
        q, kp, vp, tbl, ln_, ql = _paged(2, 2, 2, 16, 8, 8, [9, 6],
                                         [2, 2], seed=1)
        kernels.maybe_paged_attention(*_t(q[:, 0].copy(), kp, vp, tbl,
                                          ln_))
        kernels.maybe_paged_attention_multiquery(
            *_t(q, ql, kp, vp, tbl, ln_))
        kernels.maybe_layer_norm(torch.randn(4, 8), torch.ones(8),
                                 torch.zeros(8), 1e-5, 1)
        assert kernels.launch_counts() == {
            "layer_norm": 0, "paged_attention": 0,
            "paged_attention_multiquery": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_fused": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0, "fused_xent_fwd": 0,
            "fused_xent_bwd_dlog": 0, "fused_xent_bwd_dh": 0,
            "fused_xent_bwd_dw": 0, "adam_leaf": 0, "adam_flat": 0}

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            ln.layer_norm(torch.randn(4, 8), torch.ones(8), torch.zeros(8))
        q, kp, vp, tbl, ln_ = _paged(1, None, 2, 16, 4, 4, [3])
        with pytest.raises(ValueError, match="CUDA"):
            pa.paged_attention(*_t(q, kp, vp, tbl, ln_))

    def test_ctypes_signatures_match_the_c_entry_points(self):
        for name, fns in _build.SOURCES.items():
            src = (_build.CSRC / f"{name}.cu").read_text()
            assert 'extern "C" const char* cuda_error_string(int code)' \
                in src
            for fn, argtypes in fns.items():
                m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)",
                              src)
                assert m, fn
                params = [p for p in m.group(1).split(",") if p.strip()]
                assert len(params) == len(argtypes), fn
                assert m.group(1).split(",")[-1].strip() \
                    == "void* stream", fn

    def test_missing_nvcc_raises_instead_of_falling_back(self, monkeypatch,
                                                         tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.delenv("CUDA_PATH", raising=False)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.library("layer_norm")
