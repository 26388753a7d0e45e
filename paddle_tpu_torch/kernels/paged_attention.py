"""Ragged paged attention: the CUDA kernels' wrappers and plain versions.

The kernels (``csrc/paged_attention.cu``) replace the Pallas kernels of
``paddle_tpu/kernels/paged_attention.py``: ``_paged_attn_kernel`` (single
query per sequence, every decode step) and ``_paged_attn_mq_kernel`` (a
window of query rows per sequence, the speculative verify step). The
source note gives the design.

Shapes: q ``[B, H, D]`` (multi-query: ``[B, Qmax, H, D]`` plus ``q_lens``
``[B]``); pools ``[N, block_size, H, D]``; ``block_tables``
``[B, max_blocks]`` int (entries past a sequence's blocks are ignored,
and clamped into the pool); ``context_lens`` ``[B]`` int counting every
valid token, the query's own included. fp32 throughout. Head dim at
most 128: the C entry refuses a larger one, and its launch check raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_multiquery",
           "paged_attention_plain", "paged_attention_multiquery_plain"]

_NEG_INF = -1e30

# kernel launches since the last reset (kernels.reset_launch_counts)
launches = 0
mq_launches = 0


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[B, max_blocks * bs, H, D] dense view of each sequence's blocks
    (table entries clamped into the pool)."""
    b, maxb = tables.shape
    idx = tables.long().clamp(0, pool.shape[0] - 1)
    return pool[idx].reshape(b, maxb * pool.shape[1], *pool.shape[2:])


def paged_attention_plain(q, k_pool, v_pool, block_tables, context_lens,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Gather each sequence's blocks and run masked softmax attention in
    plain PyTorch: the oracle of the single-query kernel, and its
    stand-in for CPU tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    s = torch.einsum("bhd,bthd->bht", q.float() * scale, k)
    pos = torch.arange(k.shape[1], device=q.device)
    lens = context_lens.to(q.device).long()
    s = s.masked_fill(~(pos[None, None, :] < lens[:, None, None]),
                      _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bthd->bhd", p, v).to(q.dtype)


def paged_attention_multiquery_plain(q, q_lens, k_pool, v_pool,
                                     block_tables, context_lens,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Plain PyTorch multi-query window attention: row qi of sequence b
    attends keys [0, ctx - q_len + qi] (padded rows the whole context).
    A Qmax == 1 batch goes through :func:`paged_attention_plain`, as the
    kernel wrapper sends it to the single-query kernel."""
    if q.shape[1] == 1:
        return paged_attention_plain(q[:, 0], k_pool, v_pool, block_tables,
                                     context_lens, scale)[:, None]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    s = torch.einsum("bqhd,bthd->bhqt", q.float() * scale, k)
    lens = context_lens.to(q.device).long()
    qlens = q_lens.to(q.device).long()
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    qpos = (lens - qlens)[:, None, None, None] + torch.arange(
        q.shape[1], device=q.device)[None, None, :, None]
    mask = (kpos <= qpos) & (kpos < lens[:, None, None, None])
    s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p, v).to(q.dtype)


def _check_args(q, k_pool, v_pool, ints) -> None:
    if q.device.type != "cuda":
        raise ValueError("paged attention kernel needs CUDA tensors")
    for t in (q, k_pool, v_pool):
        if t.device != q.device or t.dtype != torch.float32:
            raise TypeError("paged attention kernel takes float32 q and "
                            "pools on one device")
        if not t.is_contiguous():
            raise ValueError("paged attention kernel needs contiguous q "
                             "and pools")
    for t in ints:
        if t.device != q.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise TypeError("block tables and lengths must be contiguous "
                            "int32 on the query's device")
    if k_pool.shape != v_pool.shape:
        raise ValueError("k_pool and v_pool shapes differ")


def paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Single-query ragged paged attention through the CUDA kernel.
    Returns ``[B, H, D]``."""
    global launches
    b, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _check_args(q, k_pool, v_pool, (block_tables, context_lens))
    if k_pool.shape[2:] != (h, d) or block_tables.shape[0] != b \
            or context_lens.shape != (b,):
        raise ValueError("paged attention shapes disagree")
    out = torch.empty_like(q)
    lib = _build.library("paged_attention")
    code = lib.paged_attention_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, h, d, k_pool.shape[0], k_pool.shape[1], block_tables.shape[1],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_attention", code, "paged_attention_fwd")
    launches += 1
    return out


def paged_attention_multiquery(q, q_lens, k_pool, v_pool, block_tables,
                               context_lens,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Multi-query ragged paged attention through the CUDA kernel.
    Returns ``[B, Qmax, H, D]``. A Qmax == 1 batch runs the single-query
    kernel, so it is bit-identical to :func:`paged_attention`."""
    global mq_launches
    b, qmax, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if qmax == 1:
        return paged_attention(q[:, 0].contiguous(), k_pool, v_pool,
                               block_tables, context_lens,
                               scale)[:, None]
    _check_args(q, k_pool, v_pool, (q_lens, block_tables, context_lens))
    if k_pool.shape[2:] != (h, d) or block_tables.shape[0] != b \
            or context_lens.shape != (b,) or q_lens.shape != (b,):
        raise ValueError("paged attention shapes disagree")
    out = torch.empty_like(q)
    lib = _build.library("paged_attention")
    code = lib.paged_attention_mq_fwd(
        q.data_ptr(), q_lens.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), b, qmax, h, d,
        k_pool.shape[0], k_pool.shape[1], block_tables.shape[1],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_attention", code, "paged_attention_mq_fwd")
    mq_launches += 1
    return out
