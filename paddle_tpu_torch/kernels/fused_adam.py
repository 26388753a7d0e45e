"""Paddle's Adam update in one multi-tensor CUDA launch: the kernel's
wrapper and the plain versions of its two variants.

The kernel (``csrc/fused_adam.cu``) replaces the Pallas kernels of
``paddle_tpu/kernels/fused_adam.py``: ``_adam_leaf_kernel`` (variant
``"leaf"``, the unfused update's exact order of operations) and
``_adam_kernel`` (variant ``"flat"``, the reciprocal form with an
optional ``weight_decay`` term). Both compute, with the bias correction
already folded into ``lr_c``,

    m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2,
    leaf: p - lr_c m / (sqrt(v) + eps)
    flat: p - lr_c (m (1 / (sqrt(v) + eps)) [+ wd p])

and then, for the leaves whose ``decay`` flag is set, AdamW's decoupled
``p_new - (lr wd) p_old``. One launch updates every leaf of a step in
place; ``lr_c``, the skip-step guard's ``ok`` and, for a scheduled
rate, ``lr wd`` stay on the device, and with ``ok`` False nothing is
written. In bf16 training the leaves are the fp32 master weights (see
``optimizer``). On the card the kernel equals
:func:`adam_multi_plain` bit for bit (each operation rounded on its own,
as PyTorch's eager ops round them). The kernel finds the leaves through
a table of their pointers and sizes, built on the host once per set of
pointers and kept on the device (:func:`leaf_table`); while a CUDA graph
is captured, :func:`captured_tables` gives the table rows of a buffer
made before the capture and fills them after it.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch

from . import _build

__all__ = ["adam_leaf_plain", "adam_flat_plain", "adam_multi",
           "adam_multi_plain", "leaf_rows", "leaf_table", "captured_tables",
           "CHUNK", "VARIANTS"]

# kernel launches since the last reset (kernels.reset_launch_counts), by
# variant
leaf_launches = 0
flat_launches = 0

CHUNK = 8192  # elements per CUDA block (kChunk in the source)
VARIANTS = ("leaf", "flat")
# leaf tables kept on the device (leaf_table) and how many were built
TABLES_KEPT = 8
_tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
table_builds = 0
# (buffer, [(table, rows)]) inside captured_tables(), else None
_captured: Optional[tuple] = None


def adam_leaf_plain(p, g, m, v, lr_c, beta1: float, beta2: float,
                    eps: float):
    """The leaf variant: the port's unfused update as written. Returns
    (p_new, m_new, v_new)."""
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * (g * g)
    return p - lr_c * m / (torch.sqrt(v) + eps), m, v


def adam_flat_plain(p, g, m, v, lr_c, beta1: float, beta2: float,
                    eps: float, weight_decay: float = 0.0):
    """The flat variant: the update as ``m * (1 / (sqrt(v) + eps))``,
    plus ``weight_decay * p`` when that is non-zero. Returns (p_new,
    m_new, v_new)."""
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * (g * g)
    update = m * torch.reciprocal(torch.sqrt(v) + eps)
    if weight_decay:
        update = update + weight_decay * p
    return p - lr_c * update, m, v


def adam_multi_plain(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                     decay: Sequence[bool], lr_c: torch.Tensor,
                     beta1: float, beta2: float, eps: float,
                     lr_wd: Union[float, torch.Tensor],
                     ok: Optional[torch.Tensor] = None,
                     variant: str = "leaf",
                     weight_decay: float = 0.0) -> None:
    """:func:`adam_multi`'s plain version: the same update of every leaf,
    in place, one leaf at a time; ``torch.where(ok, new, old)`` for the
    skip-step guard. Moments stored in bf16 (``optimizer_moment_dtype``)
    are read as fp32 and stored back rounded: the math is fp32 either
    way. ``lr_wd`` may be a float or a one-element fp32 tensor (a
    scheduled learning rate)."""
    for p, g, m, v, dec in zip(params, grads, ms, vs, decay):
        m32, v32 = m.float(), v.float()  # the tensors themselves if fp32
        if variant == "leaf":
            new = adam_leaf_plain(p, g, m32, v32, lr_c, beta1, beta2, eps)
        else:
            new = adam_flat_plain(p, g, m32, v32, lr_c, beta1, beta2, eps,
                                  weight_decay)
        p_new = new[0] - lr_wd * p if dec else new[0]
        for dst, val in ((m, new[1]), (v, new[2]), (p, p_new)):
            dst.copy_(val if ok is None else torch.where(ok, val, dst))


def leaf_rows(params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
              vs: Sequence[torch.Tensor], decay: Sequence[bool]
              ) -> Tuple[Tuple[Tuple[int, ...], ...], int]:
    """The kernel's leaf table on the host: ``(rows, chunks)``, one row
    ``(p, g, m, v, numel, first chunk, decay, 0)`` per non-empty leaf
    (data pointers as ints) and the chunk count. Raises unless every
    leaf is a contiguous float32 tensor of one size on the first
    parameter's device."""
    dev = params[0].device
    rows: List[Tuple[int, ...]] = []
    chunks = 0
    for p, g, m, v, dec in zip(params, grads, ms, vs, decay):
        for t in (p, g, m, v):
            if t.device != dev or t.dtype != torch.float32 \
                    or not t.is_contiguous() or t.numel() != p.numel():
                raise TypeError(f"fused Adam kernel takes contiguous "
                                f"float32 leaves of one size on {dev} "
                                f"({t.dtype}, {tuple(t.shape)}, "
                                f"{t.device})")
        n = p.numel()
        if n == 0:
            continue
        rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(),
                     v.data_ptr(), n, chunks, int(bool(dec)), 0))
        chunks += -(-n // CHUNK)
    return tuple(rows), chunks


def _stream_key(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream \
        if dev.type == "cuda" else 0


def leaf_table(rows: Tuple[Tuple[int, ...], ...],
               dev: torch.device) -> torch.Tensor:
    """The leaf table ``rows`` as an int64 ``[len(rows), 8]`` tensor on
    ``dev``, built once per set of pointers: the last ``TABLES_KEPT``
    tables are kept by (device, stream, rows), so a step whose leaves sit
    where they sat before copies nothing. Inside
    :func:`captured_tables` the table is rows of that block's buffer,
    filled after the capture (capture runs nothing, and a host-to-device
    copy captured into a graph would read its host block at every
    replay)."""
    global table_builds
    if _captured is not None:
        buf, pending = _captured
        used = sum(len(r) for _, r in pending)
        if used + len(rows) > buf.shape[0]:
            raise RuntimeError(f"captured_tables({buf.shape[0]}) holds "
                               f"too few rows for {used + len(rows)}")
        table = buf[used:used + len(rows)]
        pending.append((table, rows))
        return table
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the fused Adam kernel's leaf table must be "
                           "made inside captured_tables() while a CUDA "
                           "graph is captured")
    key = (dev, _stream_key(dev), rows)
    table = _tables.get(key)
    if table is not None:
        _tables.move_to_end(key)
        return table
    host = torch.tensor(rows, dtype=torch.int64)
    if dev.type == "cuda":
        # one asynchronous copy from pinned memory (PyTorch's pinned
        # allocator keeps the block until the copy is done)
        host = host.pin_memory()
    table = _tables[key] = host.to(dev, non_blocking=True)
    table_builds += 1
    while len(_tables) > TABLES_KEPT:
        _tables.popitem(last=False)
    return table


@contextlib.contextmanager
def captured_tables(capacity: int,
                    dev: torch.device) -> Iterator[List[torch.Tensor]]:
    """Hands the leaf tables made while a CUDA graph is captured inside
    the block rows of one buffer of ``capacity`` rows, allocated before
    the capture, and fills them when the block exits (after the capture).
    The buffer must lie outside the graph's memory pool: the graph reuses
    its pool's memory for tensors whose lifetimes do not overlap, and a
    table filled from outside would be overwritten by a replay before
    the kernel reads it. Yields the list of the tables: keep it as long
    as the graph."""
    global _captured
    if _captured is not None:
        raise RuntimeError("captured_tables() does not nest")
    buf = torch.empty((capacity, 8), dtype=torch.int64, device=dev)
    made: List[torch.Tensor] = []
    pending: list = []
    _captured = (buf, pending)
    try:
        yield made
    finally:
        _captured = None
    for table, rows in pending:
        table.copy_(torch.tensor(rows, dtype=torch.int64))
        made.append(table)


def adam_multi(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
               decay: Sequence[bool], lr_c: torch.Tensor, beta1: float,
               beta2: float, eps: float,
               lr_wd: Union[float, torch.Tensor],
               ok: Optional[torch.Tensor] = None, variant: str = "leaf",
               weight_decay: float = 0.0) -> None:
    """One launch of the kernel over every leaf: updates ``params``,
    ``ms`` and ``vs`` in place. Leaves are contiguous float32 CUDA
    tensors of matching sizes; ``lr_c`` a one-element float32 and ``ok``
    (or None) a one-element bool tensor on the same card; ``lr_wd`` a
    float, or a one-element float32 tensor there (read on the device: a
    scheduled learning rate needs no host sync). Raises on anything else
    (CPU tensors go to :func:`adam_multi_plain`)."""
    global leaf_launches, flat_launches
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    if not params:
        return
    dev = params[0].device
    if dev.type != "cuda":
        raise ValueError(f"fused Adam kernel needs CUDA tensors (a "
                         f"parameter is on {dev})")
    rows, chunks = leaf_rows(params, grads, ms, vs, decay)
    if not rows:
        return
    lr_wd_dev = lr_wd if isinstance(lr_wd, torch.Tensor) else None
    for t, what in ((lr_c, "lr_c"), (ok, "ok"), (lr_wd_dev, "lr_wd")):
        if t is not None and (t.device != dev or t.numel() != 1):
            raise TypeError(f"{what} must be a one-element tensor on {dev}")
    if lr_c.dtype != torch.float32 or (ok is not None
                                       and ok.dtype != torch.bool) or (
            lr_wd_dev is not None and lr_wd_dev.dtype != torch.float32):
        raise TypeError("lr_c and lr_wd must be float32 and ok bool")
    table = leaf_table(rows, dev)
    # the scalars are Python floats (1 - beta1 taken in double), which
    # ctypes rounds to float32 as PyTorch hands them to a float32 kernel
    code = _build.library("fused_adam").fused_adam_multi(
        table.data_ptr(), len(rows), chunks, lr_c.data_ptr(),
        None if ok is None else ok.data_ptr(),
        None if lr_wd_dev is None else lr_wd_dev.data_ptr(), beta1,
        1 - beta1, beta2, 1 - beta2, eps,
        0.0 if lr_wd_dev is not None else lr_wd, weight_decay,
        VARIANTS.index(variant), torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_adam", code, "fused_adam_multi")
    if variant == "leaf":
        leaf_launches += 1
    else:
        flat_launches += 1
