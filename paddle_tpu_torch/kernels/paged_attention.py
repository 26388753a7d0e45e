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

Both entries run one split-KV kernel: each context is cut into chunks of ``CHUNK_TOKENS`` tokens, one CUDA
block per (head, sequence, chunk) takes every query row of its sequence
(the verify window in groups of ``ROW_GROUP`` rows over the same K/V
tiles), and the chunks' softmax states are merged in chunk order.
:func:`paged_attention_multiquery_split_plain` is that decomposition in
plain PyTorch, chunk partials, per-row limits and merge, and
:func:`paged_attention_split_plain` its single-query case; the CPU tests
hold them against the JAX kernels and ``chip_smoke.py`` holds the kernels
against them on the card.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_multiquery",
           "paged_attention_plain", "paged_attention_multiquery_plain",
           "paged_attention_split_plain",
           "paged_attention_multiquery_split_plain", "CHUNK_TOKENS",
           "ROW_GROUP"]

_NEG_INF = -1e30
# tokens of one work item, one CUDA block per (head, sequence, chunk): its
# 4 warps' 32-token tiles (kChunk in the source, which refuses another
# value)
CHUNK_TOKENS = 128
# verify-window rows the kernel takes in one pass over a chunk's tiles
# (kRowGroup in the source)
ROW_GROUP = 4

# kernel launches since the last reset (kernels.reset_launch_counts),
# counted under a lock: serving threads launch concurrently
launches = 0
mq_launches = 0
_count_lock = threading.Lock()


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
    """The single-query kernel's decomposition in plain PyTorch: a window
    of one row attending the whole context, through
    :func:`paged_attention_multiquery_split_plain`."""
    return paged_attention_multiquery_split_plain(
        q[:, None], None, k_pool, v_pool, block_tables, context_lens, scale,
        chunk_tokens)[:, 0]


def paged_attention_multiquery_split_plain(q, q_lens, k_pool, v_pool,
                                           block_tables, context_lens,
                                           scale: Optional[float] = None,
                                           chunk_tokens: int = CHUNK_TOKENS,
                                           row_group: int = ROW_GROUP
                                           ) -> torch.Tensor:
    """The kernels' decomposition in plain PyTorch. Each sequence's
    context is cut into chunks of ``chunk_tokens`` tokens; the window's
    rows go in groups of ``row_group``; row qi attends keys [0, limit) with
    limit ``ctx - q_len + qi + 1`` (padded rows, a ``Qmax == 1`` window and
    ``q_lens=None``: the whole context), and a token past it gets p = 0, so
    a chunk wholly past a row's limit gives that row the empty partial
    (m = -1e30, l = 0, acc = 0). Each (row, chunk) partial is its own max,
    the sum and P V under that max; the partials merge in chunk order:
    ``M = max m_c``, ``L = sum l_c e^(m_c - M)``, ``out = sum acc_c e^(m_c -
    M) / max(L, 1e-30)``. The context is clamped to what the table
    addresses, as the kernel clamps it; an empty row gives 0."""
    if chunk_tokens <= 0 or row_group <= 0:
        raise ValueError(f"chunk_tokens and row_group must be positive, "
                         f"got {chunk_tokens} and {row_group}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    b, t, h, d = k.shape
    qmax = q.shape[1]
    n_ch = -(-t // chunk_tokens)
    pad = n_ch * chunk_tokens - t
    ctx = context_lens.to(q.device).long()
    lens = ctx.clamp(0, t)
    limit = lens[:, None].expand(b, qmax)
    if q_lens is not None and qmax > 1:
        qi = torch.arange(qmax, device=q.device)[None, :]
        ql = q_lens.to(q.device).long()[:, None]
        limit = torch.minimum(torch.where(qi < ql, ctx[:, None] - ql + qi + 1,
                                          limit), limit)
    kpos = torch.arange(n_ch * chunk_tokens, device=q.device)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        b, n_ch, chunk_tokens, h, d)
    outs = []
    for r0 in range(0, qmax, row_group):
        qg = q[:, r0:r0 + row_group].float() * scale
        g = qg.shape[1]
        valid = (kpos[None, None, :] < limit[:, r0:r0 + g, None])[:, None]
        s = torch.nn.functional.pad(
            torch.einsum("bghd,bthd->bhgt", qg, k), (0, pad), value=_NEG_INF)
        s = s.masked_fill(~valid, _NEG_INF).reshape(b, h, g, n_ch,
                                                    chunk_tokens)
        valid = valid.expand(b, h, g, kpos.numel()).reshape(s.shape)
        # each (row, chunk) partial: its own max, the sum and P V under it
        m_c = s.amax(dim=-1)
        p = torch.exp(s - m_c[..., None]) * valid
        l_c = p.sum(dim=-1)
        acc_c = torch.einsum("bhgcx,bcxhd->bhgcd", p, v)
        # the merge, in chunk order
        m = m_c.amax(dim=-1, keepdim=True)
        w = torch.exp(m_c - m)
        l = (l_c * w).sum(dim=-1)
        out = (acc_c * w[..., None]).sum(dim=3)
        outs.append(out / l.clamp_min(1e-30)[..., None])
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


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


def _launch(entry: str, q, q_lens, k_pool, v_pool, block_tables,
            context_lens, scale: float) -> torch.Tensor:
    """One launch of the split kernel through C entry ``entry``: the
    chunks' scratch allocated here, the tickets from the cache."""
    mq = q.ndim == 4  # the verify entry also takes q_lens and Qmax
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    qmax = q.shape[1] if mq else 1
    out = torch.empty_like(q)
    n_blocks, bs = k_pool.shape[:2]
    max_blocks = block_tables.shape[1]
    max_chunks = max(1, -(-max_blocks * bs // CHUNK_TOKENS))
    # the chunks' per-row (acc, M, L), read only where a sequence has
    # several
    part = torch.empty(b * h * max_chunks * qmax * (d + 2)
                       if max_chunks > 1 else 1, dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = _tickets(q.device, stream, b * h)
    lib = _build.library("paged_attention")
    code = getattr(lib, entry)(
        q.data_ptr(), *([q_lens.data_ptr()] if mq else []),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), b, *([qmax] if mq else []), h, d, n_blocks, bs,
        max_blocks, CHUNK_TOKENS, float(scale), stream)
    _build.check("paged_attention", code, entry)
    return out


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
    out = _launch("paged_attention_fwd", q, None, k_pool, v_pool,
                  block_tables, context_lens, scale)
    with _count_lock:
        launches += 1
    return out


# the kernel's merge tickets, per (device, stream): zeroed once, and every
# launch leaves the ones it used at zero again
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
    entry, so it is bit-identical to :func:`paged_attention`."""
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
    out = _launch("paged_attention_mq_fwd", q, q_lens, k_pool, v_pool,
                  block_tables, context_lens, scale)
    with _count_lock:
        mq_launches += 1
    return out
