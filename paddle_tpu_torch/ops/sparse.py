"""Sparse row-slice gradients (the reference's SelectedRows).

Counterpart of ``paddle_tpu.ops.sparse`` (the reference's
``selected_rows.h`` and ``math/selected_rows_functor.cc``): a
:class:`RowSlices` is a ``(rows, values)`` pair, ``values[i]`` belonging
to row ``rows[i]`` of a ``dense_rows``-row tensor, as an embedding
lookup's gradient comes. The optimizers take one in place of a dense
gradient (``Optimizer.update_sparse``): the touched rows alone are read
and written. Shapes stay static: ``merge_rows`` keeps the row count,
parking the merged-away slots on the dummy row ``dense_rows``, which
every apply drops.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["RowSlices", "to_dense", "merge_rows", "scatter_apply",
           "embedding_grad", "add"]


class RowSlices:
    """Sparse gradient: ``values[i]`` belongs to full row ``rows[i]``."""

    def __init__(self, rows: torch.Tensor, values: torch.Tensor,
                 dense_rows: int) -> None:
        self.rows = rows
        self.values = values
        self.dense_rows = int(dense_rows)

    @property
    def dense_shape(self) -> Tuple[int, ...]:
        return (self.dense_rows,) + tuple(self.values.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def __repr__(self) -> str:
        return (f"RowSlices(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, "
                f"dense_rows={self.dense_rows})")


def to_dense(s: RowSlices) -> torch.Tensor:
    """(ref: get_tensor_from_selected_rows_op.cc) duplicate rows sum;
    the dummy row is dropped."""
    out = torch.zeros((s.dense_rows + 1,) + tuple(s.values.shape[1:]),
                      dtype=s.values.dtype, device=s.values.device)
    rows = s.rows.long().clamp(max=s.dense_rows)
    return out.index_add(0, rows, s.values)[:s.dense_rows]


def merge_rows(s: RowSlices) -> RowSlices:
    """(ref: merge_selected_rows_op.cc) duplicate rows summed into one
    slot, in ascending row order; the freed slots at the end carry the
    dummy row ``dense_rows`` and zero values."""
    rows = s.rows.long()
    order = torch.argsort(rows, stable=True)
    rows_sorted = rows[order]
    is_first = torch.cat([torch.ones(1, dtype=torch.bool,
                                     device=rows.device),
                          rows_sorted[1:] != rows_sorted[:-1]])
    seg = torch.cumsum(is_first.long(), dim=0) - 1
    merged_vals = torch.zeros_like(s.values).index_add(
        0, seg, s.values[order])
    merged_rows = torch.full_like(rows_sorted, s.dense_rows).scatter(
        0, seg, rows_sorted)
    return RowSlices(merged_rows, merged_vals, s.dense_rows)


def scatter_apply(param: torch.Tensor, s: RowSlices,
                  fn: Callable) -> torch.Tensor:
    """``param`` with ``fn(param_rows, grad_values)`` applied to the
    touched rows only (a duplicate row's deltas add; the dummy row is
    dropped). Returns a new tensor."""
    rows = s.rows.long()
    safe = rows.clamp(max=s.dense_rows - 1)
    valid = (rows < s.dense_rows).to(param.dtype).reshape(
        (-1,) + (1,) * (param.ndim - 1))
    current = param[safe]
    delta = (fn(current, s.values) - current) * valid
    return param.index_add(0, safe, delta)


def embedding_grad(ids: torch.Tensor, grad_out: torch.Tensor,
                   vocab_size: int) -> RowSlices:
    """The sparse gradient of an embedding lookup (ref:
    lookup_table_v2_op's grad -> SelectedRows): one slice per looked-up
    id, duplicates unmerged."""
    return RowSlices(ids.reshape(-1).long(),
                     grad_out.reshape(-1, grad_out.shape[-1]), vocab_size)


def add(a: RowSlices, b: RowSlices) -> RowSlices:
    """(ref: selected_rows_functor sum) the slices of both, unmerged."""
    if a.dense_rows != b.dense_rows:
        raise ValueError(f"RowSlices add: {a.dense_rows} rows against "
                         f"{b.dense_rows}")
    return RowSlices(torch.cat([a.rows.long(), b.rows.long()]),
                     torch.cat([a.values, b.values]), a.dense_rows)
