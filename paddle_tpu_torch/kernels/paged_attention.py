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

The single-query kernel splits each context into chunks of
``CHUNK_TOKENS`` tokens, one CUDA block per (head, sequence, chunk),
and merges the chunks' softmax states in chunk order (the source note
gives the design). :func:`paged_attention_split_plain` is that
decomposition in plain PyTorch, chunk partials and merge, held against
the JAX kernel by the CPU tests and against the kernel on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_multiquery",
           "paged_attention_plain", "paged_attention_multiquery_plain",
           "paged_attention_split_plain", "CHUNK_TOKENS"]

_NEG_INF = -1e30
# tokens of one work item of the single-query kernel, one CUDA block per
# (head, sequence, chunk): its 4 warps' 32-token tiles (kChunk in the
# source, which refuses another value)
CHUNK_TOKENS = 128

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


def paged_attention_split_plain(q, k_pool, v_pool, block_tables,
                                context_lens, scale: Optional[float] = None,
                                chunk_tokens: int = CHUNK_TOKENS
                                ) -> torch.Tensor:
    """The single-query kernel's decomposition in plain PyTorch: each
    sequence's context cut into chunks of ``chunk_tokens`` tokens, a
    softmax partial (m, l, acc) per chunk, then the partials merged in
    chunk order: ``M = max m_c``, ``L = sum l_c e^(m_c - M)``, ``out =
    sum acc_c e^(m_c - M) / max(L, 1e-30)``. The context is clamped to
    what the table addresses, as the kernel clamps it; an empty row
    gives 0."""
    if chunk_tokens <= 0:
        raise ValueError(f"chunk_tokens must be positive, got "
                         f"{chunk_tokens}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    b, t, h, d = k.shape
    n_ch = -(-t // chunk_tokens)
    pad = n_ch * chunk_tokens - t
    s = torch.einsum("bhd,bthd->bht", q.float() * scale, k)
    lens = context_lens.to(q.device).long().clamp(0, t)
    valid = torch.arange(t, device=q.device)[None, None, :] \
        < lens[:, None, None]
    s = torch.nn.functional.pad(s.masked_fill(~valid, _NEG_INF), (0, pad),
                                value=_NEG_INF)
    valid = torch.nn.functional.pad(valid.expand(b, h, t), (0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    s = s.reshape(b, h, n_ch, chunk_tokens)
    valid = valid.reshape(b, h, n_ch, chunk_tokens)
    v = v.reshape(b, n_ch, chunk_tokens, h, d)
    # each chunk's partial: its own max, the sum and P V under that max
    m_c = s.amax(dim=-1)
    p = torch.exp(s - m_c[..., None]) * valid
    l_c = p.sum(dim=-1)
    acc_c = torch.einsum("bhcx,bcxhd->bhcd", p, v)
    # the merge, in chunk order
    m = m_c.amax(dim=-1, keepdim=True)
    w = torch.exp(m_c - m)
    l = (l_c * w).sum(dim=-1)
    out = (acc_c * w[..., None]).sum(dim=2)
    return (out / l.clamp_min(1e-30)[..., None]).to(q.dtype)


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
    n_blocks, bs = k_pool.shape[:2]
    max_blocks = block_tables.shape[1]
    max_chunks = max(1, -(-max_blocks * bs // CHUNK_TOKENS))
    # the chunks' (acc, M, L), read only where a sequence has several
    part = torch.empty(b * h * max_chunks * (d + 2) if max_chunks > 1
                       else 1, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, b * h)
    lib = _build.library("paged_attention")
    code = lib.paged_attention_fwd(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), b, h, d, n_blocks, bs,
        max_blocks, CHUNK_TOKENS, float(scale), stream)
    _build.check("paged_attention", code, "paged_attention_fwd")
    launches += 1
    return out


# the single-query kernel's merge tickets, per (device, stream): zeroed
# once, and every launch leaves the ones it used at zero again
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = t
    return t


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
