"""Ragged-sequence ops.

Counterpart of ``paddle_tpu.ops.sequence`` (the reference's LoD sequence
ops, ``operators/sequence_ops/``) with its dense layout: a ragged batch
is a padded ``[batch, max_len, ...]`` tensor plus per-row lengths, and
every op takes ``(x, length)`` with the JAX semantics (``sequence_unpad``
zeroes the positions past ``length``; it returns no ragged list).
Shapes are static: the lengths are read on the host only where the
output's shape depends on them (``sequence_mask`` without ``maxlen``,
``sequence_expand`` without ``max_len``, ``sequence_expand_as``,
``lod_reset``), as the JAX package reads them eagerly, and by
``sequence_reshape``'s divisibility check outside a CUDA graph capture.
Integer outputs (lengths, ids, indices) are int64, Paddle's dtype (the
JAX package gives int32 with x64 off); the values agree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ._common import as_tensor

__all__ = ["sequence_mask", "sequence_pool", "sequence_softmax",
           "sequence_pad", "sequence_unpad", "sequence_reverse",
           "sequence_expand", "sequence_expand_dense", "sequence_concat",
           "sequence_enumerate", "sequence_erase", "sequence_slice",
           "sequence_first_step", "sequence_last_step", "sequence_conv",
           "sequence_expand_as", "sequence_reshape", "sequence_scatter",
           "sequence_topk_avg_pooling", "lod_reset", "filter_by_instag",
           "edit_distance", "ctc_greedy_decoder", "lod_append",
           "reorder_lod_tensor_by_rank"]


def _capturing() -> bool:
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


def _steps(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def _tail(m: torch.Tensor, ndim: int) -> torch.Tensor:
    """``m`` ([B, T]) with ``ndim - 2`` trailing unit dims."""
    return m.reshape(m.shape + (1,) * (ndim - 2))


def _mask(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    length = as_tensor(length, like=x)
    return _tail(_steps(x.shape[1], x)[None, :] < length.reshape(-1, 1),
                 x.ndim)


def _gather_time(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, t], ...]`` (``take_along_axis`` on axis 1)."""
    idx = _tail(idx.long(), x.ndim)
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def sequence_mask(lengths, maxlen: Optional[int] = None, dtype="bool"):
    """(ref: sequence_mask_op.cc). Without ``maxlen`` the longest length,
    read on the host."""
    lengths = as_tensor(lengths)
    if maxlen is None:
        maxlen = int(lengths.max())
    mask = _steps(int(maxlen), lengths)[None, :] < lengths.reshape(-1, 1)
    return mask.to(convert_dtype(dtype))


def sequence_pool(x, length, pool_type: str = "sum", pad_value: float = 0.0):
    """(ref: sequence_pool_op.cc) x: [B, T, ...], length: [B]."""
    length = as_tensor(length, like=x)
    mask = _mask(x, length)
    empty = (length == 0).reshape((-1,) + (1,) * (x.ndim - 2))
    if pool_type in ("sum", "sqrt", "average", "mean"):
        s = torch.sum(x * mask.to(x.dtype), dim=1)
        den = length.clamp(min=1).reshape((-1,) + (1,) * (s.ndim - 1))
        if pool_type == "sum":
            out = s
        elif pool_type == "sqrt":
            out = s / torch.sqrt(den.to(torch.float32)).to(x.dtype)
        else:
            out = s / den.to(x.dtype)
    elif pool_type == "max":
        out = torch.amax(torch.where(mask, x, float("-inf")), dim=1)
    elif pool_type == "min":
        out = torch.amin(torch.where(mask, x, float("inf")), dim=1)
    elif pool_type == "first":
        out = x[:, 0]
    elif pool_type == "last":
        idx = (length - 1).clamp(min=0).reshape(-1, 1)
        out = _gather_time(x, idx)[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    return torch.where(empty, torch.full_like(out, pad_value), out)


def sequence_softmax(x, length):
    """(ref: sequence_softmax_op.cc) softmax over the valid time steps."""
    mask = _mask(x, length)
    masked = torch.where(mask, x, torch.finfo(x.dtype).min)
    return torch.where(mask, torch.softmax(masked, dim=1), 0.0)


def sequence_pad(x, length, max_len: int, pad_value: float = 0.0):
    """(ref: sequence_pad_op.cc) re-pads to ``max_len``."""
    t = x.shape[1]
    if max_len <= t:
        out = x[:, :max_len]
    else:
        pads = [0, 0] * (x.ndim - 2) + [0, max_len - t]
        out = torch.nn.functional.pad(x, pads, value=pad_value)
    return torch.where(_mask(out, length), out,
                       torch.full_like(out, pad_value))


def sequence_unpad(x, length):
    """(ref: sequence_unpad_op.cc) zeroes the positions past ``length``."""
    return x * _mask(x, length).to(x.dtype)


def sequence_reverse(x, length):
    """(ref: sequence_reverse_op.cc) reverses each row's valid prefix."""
    idx = _steps(x.shape[1], x)[None, :]
    L = as_tensor(length, like=x).reshape(-1, 1)
    return _gather_time(x, torch.where(idx < L, L - 1 - idx, idx))


def sequence_expand(x, ref_length, max_len: Optional[int] = None):
    """(ref: sequence_expand_op.cc): row ``b`` of the ``[B, max_len,
    ...]`` result holds ``x[b]`` repeated ``ref_length[b]`` times, then
    zeros. Without ``max_len`` the longest length, read on the host."""
    if max_len is None:
        max_len = int(as_tensor(ref_length, like=x).max())
    return sequence_expand_dense(x, ref_length, max_len)


def sequence_expand_dense(x, ref_length, max_len: int):
    out = x[:, None].expand((x.shape[0], max_len) + x.shape[1:])
    mask = _steps(max_len, x)[None, :] < as_tensor(
        ref_length, like=x).reshape(-1, 1)
    return out * mask.reshape(mask.shape + (1,) * (x.ndim - 1)).to(x.dtype)


def sequence_concat(xs, lengths):
    """(ref: sequence_concat_op.cc) xs: list of [B, Ti, ...]; lengths:
    list of [B]. Returns (out [B, sum(Ti), ...], out_len): each row
    holds its valid prefixes one after another, left-packed."""
    total_t = sum(x.shape[1] for x in xs)
    b, feat = xs[0].shape[0], tuple(xs[0].shape[2:])
    x0 = xs[0]
    out = torch.zeros((b, total_t + 1) + feat, dtype=x0.dtype,
                      device=x0.device)
    out_len = torch.zeros((b,), dtype=torch.int64, device=x0.device)
    for x, ln in zip(xs, lengths):
        ln = as_tensor(ln, like=x).long()
        src = _steps(x.shape[1], x)[None, :]
        # the invalid steps go to the extra slot at total_t, dropped
        dst = torch.where(src < ln.reshape(-1, 1),
                          out_len.reshape(-1, 1) + src, total_t)
        dst = _tail(dst, x.ndim).expand(x.shape)
        out = out.scatter(1, dst, x)
        out_len = out_len + ln
    return out[:, :total_t], out_len


def sequence_enumerate(x, length, win_size: int, pad_value: int = 0):
    """(ref: sequence_enumerate_op.cc) sliding windows of ids."""
    b, t = x.shape
    L = as_tensor(length, like=x).reshape(-1, 1)
    pos = _steps(t, x)[None, :]
    windows = []
    for w in range(win_size):
        shifted = torch.cat([x[:, w:], torch.full(
            (b, w), pad_value, dtype=x.dtype, device=x.device)], dim=1)
        windows.append(torch.where(pos + w < L, shifted,
                                   torch.full_like(shifted, pad_value)))
    return torch.stack(windows, dim=-1)


def sequence_erase(x, length, tokens):
    """(ref: sequence_erase_op.cc) removes ``tokens``, left-packs the
    rest; returns (ids, new_length)."""
    t = x.shape[1]
    keep = torch.ones_like(x, dtype=torch.bool)
    for tok in tokens:
        keep &= x != tok
    keep &= _steps(t, x)[None, :] < as_tensor(length, like=x).reshape(-1, 1)
    new_len = keep.sum(dim=1)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    packed = torch.gather(x, 1, order)
    mask = _steps(t, x)[None, :] < new_len.reshape(-1, 1)
    return torch.where(mask, packed, torch.zeros_like(packed)), new_len


def sequence_slice(x, length, offset, size):
    """(ref: sequence_slice_op.cc) per-row slice [offset, offset+size)."""
    t = x.shape[1]
    offset = as_tensor(offset, like=x).reshape(-1, 1)
    size = as_tensor(size, like=x)
    pos = _steps(t, x)[None, :]
    shifted = _gather_time(x, (offset + pos).clamp(max=t - 1))
    mask = (pos < size.reshape(-1, 1)) & (
        pos < as_tensor(length, like=x).reshape(-1, 1) - offset)
    return (torch.where(_tail(mask, x.ndim), shifted,
                        torch.zeros_like(shifted)), size.long())


def sequence_first_step(x, length):
    return sequence_pool(x, length, "first")


def sequence_last_step(x, length):
    return sequence_pool(x, length, "last")


def sequence_conv(x, length, weight, context_length: int,
                  context_start: int = 0, bias=None):
    """(ref: sequence_conv_op.cc) context-window conv over time: x [B, T,
    D], weight [context_length * D, out]; positions outside the sequence
    contribute zeros."""
    t = x.shape[1]
    L = as_tensor(length, like=x).reshape(-1, 1)
    pos = _steps(t, x)
    cols = []
    for i in range(context_length):
        src = pos + context_start + i
        col = x[:, src.clamp(0, t - 1)]
        valid = (src >= 0)[None, :] & (src[None, :] < L)
        cols.append(col * valid[:, :, None].to(x.dtype))
    out = torch.einsum("btc,co->bto", torch.cat(cols, dim=2), weight)
    if bias is not None:
        out = out + bias
    m = pos[None, :] < L
    return out * m[:, :, None].to(out.dtype)


def sequence_expand_as(x, y_length):
    """(ref: sequence_expand_as_op.cc) row ``i`` of ``x`` [B, D] repeated
    ``y_length[i]`` times: [B, max_T, D], masked (the longest length read
    on the host)."""
    y_length = as_tensor(y_length, like=x)
    t = int(y_length.max())
    out = x[:, None].expand((x.shape[0], t) + x.shape[1:])
    m = _steps(t, x)[None, :] < y_length.reshape(-1, 1)
    return out * m.reshape(m.shape + (1,) * (x.ndim - 1)).to(x.dtype)


def sequence_reshape(x, length, new_dim: int):
    """(ref: sequence_reshape_op.cc) refolds each row's valid region into
    width ``new_dim``; returns (x', new_length). A row whose ``length *
    D`` is not a multiple of ``new_dim`` raises (checked on the host,
    except inside a CUDA graph capture, where the new length rounds up
    and the partial group is zero-padded, as JAX under tracing)."""
    b, t, d = x.shape
    if t * d % new_dim != 0:
        raise ValueError(
            f"sequence_reshape: padded row size {t}*{d} not divisible by "
            f"new_dim {new_dim}")
    length = as_tensor(length, like=x)
    if not _capturing():
        lens = length.cpu().numpy()
        if np.any(lens * d % new_dim):
            raise ValueError(
                f"sequence_reshape: row lengths {lens.tolist()} * dim {d} "
                f"not divisible by new_dim {new_dim} "
                "(ref sequence_reshape_op.cc enforces this)")
    nt = t * d // new_dim
    out = x.reshape(b, nt, new_dim)
    new_len = -torch.div(-(length.long() * d), new_dim, rounding_mode="floor")
    m = _steps(nt, x)[None, :] < new_len.reshape(-1, 1)
    return out * m[:, :, None].to(x.dtype), new_len


def sequence_scatter(x, index, updates, updates_length):
    """(ref: sequence_scatter_op.cc) per-row scatter-add of ragged
    updates: x [B, D], index [B, U] positions, updates [B, U]."""
    u = index.shape[1]
    m = _steps(u, x)[None, :] < as_tensor(updates_length,
                                          like=x).reshape(-1, 1)
    upd = updates * m.to(updates.dtype)
    idx = index.long().clamp(0, x.shape[1] - 1)
    onehot = torch.nn.functional.one_hot(idx, x.shape[1]).to(x.dtype)
    return x + torch.einsum("bud,bu->bd", onehot, upd)


def sequence_topk_avg_pooling(x, row_length, col_length, topks,
                              channel_num: int):
    """(ref: sequence_topk_avg_pooling_op.cc) x [B, C, R, Cc] match
    matrices: per row, the mean of the top-k column scores for each k in
    ``topks``; [B, R, C*len(topks)] masked by the row and column
    lengths."""
    b, c, r, cc = x.shape
    if c != channel_num:
        raise ValueError(
            f"sequence_topk_avg_pooling: x has {c} channels, expected "
            f"channel_num={channel_num}")
    col_length = as_tensor(col_length, like=x)
    cm = _steps(cc, x)[None, :] < col_length.reshape(-1, 1)
    masked = torch.where(cm[:, None, None, :], x, torch.finfo(x.dtype).min)
    vals = torch.sort(masked, dim=-1, descending=True, stable=True).values[
        ..., :min(max(topks), cc)]
    outs = []
    for k in topks:
        kk = min(k, cc)
        avail = col_length.clamp(max=kk).reshape(-1, 1, 1)
        pos_ok = _steps(kk, x)[None, None, None, :] < avail[..., None]
        s = torch.sum(torch.where(pos_ok, vals[..., :kk], 0.0), dim=-1)
        outs.append(s / avail.clamp(min=1))
    out = torch.stack(outs, dim=-1).reshape(b, c, r, len(topks))
    out = torch.movedim(out, 1, 2).reshape(b, r, c * len(topks))
    rm = _steps(r, x)[None, :] < as_tensor(row_length,
                                           like=x).reshape(-1, 1)
    return out * rm[:, :, None].to(out.dtype)


def lod_reset(x, length, new_length):
    """(ref: lod_reset_op.cc) re-segments the concatenated valid steps
    under ``new_length`` (read on the host: the padded output's shape
    depends on them)."""
    lens = np.asarray(as_tensor(length, like=x).cpu()).astype(np.int64)
    new_lens = np.asarray(
        new_length.cpu() if isinstance(new_length, torch.Tensor)
        else new_length).astype(np.int64)
    if lens.sum() != new_lens.sum():
        raise ValueError(
            f"lod_reset: old lengths sum {lens.sum()} != new lengths sum "
            f"{new_lens.sum()}")
    b, t = x.shape[0], x.shape[1]
    tail = tuple(x.shape[2:])
    valid = (np.arange(t)[None, :] < lens[:, None]).reshape(-1)
    packed = x.reshape((b * t,) + tail)[torch.from_numpy(
        np.nonzero(valid)[0]).to(x.device)]
    nb = len(new_lens)
    nt = int(new_lens.max()) if nb else 0
    rows, off = [], 0
    for ln in new_lens.tolist():
        seg = packed[off:off + ln]
        rows.append(torch.cat([seg, seg.new_zeros((nt - ln,) + tail)]))
        off += ln
    out = torch.stack(rows) if rows else x.new_zeros((0, 0) + tail)
    return out, torch.from_numpy(new_lens).to(x.device)


def filter_by_instag(x, ins_tags, filter_tags, is_lod: bool = False):
    """(ref: filter_by_instag_op.cc) keeps the rows whose tag set meets
    ``filter_tags`` (ins_tags [B, T], 0-padded): (x with the other rows
    zeroed, the [B] keep mask, its float view as the loss weight)."""
    if is_lod:
        raise NotImplementedError(
            "LoD (row-compacting) mode has no static-shape equivalent; "
            "use the dense mask semantics (is_lod=False)")
    tags = as_tensor(ins_tags, like=x)
    filt = as_tensor(filter_tags, like=x).reshape(-1)
    hit = (tags[..., None] == filt[None, None, :]) & (tags[..., None] != 0)
    mask = hit.any(dim=2).any(dim=1)
    w = mask.to(torch.float32)
    return (x * w.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype), mask,
            w)


def edit_distance(input, input_length, label, label_length,
                  normalized: bool = True):
    """Levenshtein distance per row (ref: edit_distance_op.cc; dense
    padded ids + lengths): (distance [B], sequence_num). Each row of the
    DP is one vectorised step: ``row[j] = min(c[j], min_{k<=j}(c[k] - k)
    + j)`` with ``c = min(prev + 1, prev[j-1] + cost)`` (a prefix
    minimum, as the JAX package re-associates it)."""
    input = as_tensor(input).long()
    label = as_tensor(label, like=input).long()
    b, t1 = input.shape
    t2 = label.shape[1]
    input_length = as_tensor(input_length, like=input).long().reshape(b)
    label_length = as_tensor(label_length, like=input).long().reshape(b)
    jcol = torch.arange(t2 + 1, dtype=torch.float32, device=input.device)
    row = jcol.expand(b, t2 + 1)
    rows = [row]
    big = torch.full((b, 1), 1e9, dtype=torch.float32, device=input.device)
    for i in range(t1):
        cost = (input[:, i:i + 1] != label).to(torch.float32)
        cand = torch.cat([big, torch.minimum(row[:, 1:] + 1.0,
                                             row[:, :-1] + cost)], dim=1)
        cand[:, 0] = i + 1.0  # row[0]: deletions only
        shifted = torch.cummin(cand - jcol, dim=1).values + jcol
        row = torch.minimum(cand, shifted)
        rows.append(row)
    all_rows = torch.stack(rows)  # [T1+1, B, T2+1]
    dist = all_rows[input_length, torch.arange(b, device=input.device),
                    label_length]
    if normalized:
        dist = dist / label_length.to(torch.float32).clamp(min=1.0)
    return dist, torch.full((), b, dtype=torch.int64, device=input.device)


def ctc_greedy_decoder(log_probs, length, blank: Optional[int] = None):
    """Best-path CTC decoding (ref: ctc_align_op.cu): argmax per frame,
    repeats merged, blanks dropped. log_probs [B, T, C]; ``blank``
    defaults to C-1. Returns (decoded [B, T] padded with -1,
    decoded_length [B])."""
    b, t, c = log_probs.shape
    if blank is None:
        blank = c - 1
    ids = torch.argmax(log_probs, dim=-1)
    pos = _steps(t, ids)[None, :]
    valid = pos < as_tensor(length, like=ids).reshape(b, 1)
    prev = torch.cat([torch.full((b, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    keep = valid & (ids != blank) & (ids != prev)
    order = torch.argsort(torch.where(keep, pos, t + 1), dim=1, stable=True)
    packed = torch.gather(ids, 1, order)
    n_kept = keep.sum(dim=1)
    return (torch.where(pos < n_kept[:, None], packed,
                        torch.full_like(packed, -1)), n_kept)


def lod_append(length, extra_length):
    """(ref: lod_append_op.cc) the dense layout's lengths are plain
    tensors: the appended level's lengths."""
    return as_tensor(extra_length).long()


def reorder_lod_tensor_by_rank(x, length, reverse: bool = True):
    """(ref: reorder_lod_tensor_by_rank_op.cc) rows sorted by length
    (descending by default, stable): (x_sorted, length_sorted,
    restore_index), ``x_sorted[restore_index]`` being ``x``."""
    length = as_tensor(length, like=x)
    order = torch.argsort(-length if reverse else length, stable=True)
    restore = torch.argsort(order, stable=True)
    return x[order], length[order], restore
