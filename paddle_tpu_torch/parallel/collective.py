"""Collective communication ops.

Counterpart of ``paddle_tpu.parallel.collective``, the same names,
arguments and results. A :class:`CommGroup` (the reference's ring id) names
mesh axes, or holds a ``torch.distributed`` process group; ``group=`` also
takes an axis name (resolved against ``mesh.current_mesh()``, and without
a mesh against the whole world) or a process group. Each call runs the
torch collective over that group and returns a new tensor (the JAX
functions are functional; torch's work in place). Outside an initialised
process group every call is the identity, the JAX single-process meaning.

The ops a gradient flows through are ``torch.autograd.Function``s whose
backward is the adjoint collective: ``all_gather`` <-> ``reduce_scatter``,
``all_to_all`` by the swapped split and concat axes, ``ppermute`` by the
inverse permutation (a rank that nothing is sent to gets zeros, as in
``lax.ppermute``), and ``all_reduce`` with ``sum``/``mean`` by the same
reduction (the adjoint of a sum over ranks is the sum of the cotangents).

**Backends.** NCCL takes the card's tensors. Gloo takes CPU tensors: under
Gloo every CUDA tensor is staged through a pinned host copy, the
collective runs on the copy and the result is copied back (no op is
special-cased, P2P included; ``ppermute`` is an ``all_to_all_single``
with one non-empty split per rank on either backend). Any other pair of
backend and device raises.

With FLAGS_enable_metrics, ``collective_calls_total{op=}`` and
``collective_bytes_total{op=}`` count each call and the bytes handed to
it (in a captured step: each capture, as the JAX counters count each
trace).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..observability import metrics as _obs_metrics
from . import env as _env
from . import mesh as _mesh

__all__ = ["CommGroup", "new_group", "get_group", "all_reduce",
           "all_gather", "reduce_scatter", "broadcast", "reduce", "scatter",
           "all_to_all", "ppermute", "barrier", "rank", "world_size",
           "resolve", "backend_calls", "reset_backend_calls"]

AxisName = Union[str, Sequence[str]]


def _account(op: str, x) -> None:
    """Counts one collective call and its payload bytes (metrics on)."""
    if not _obs_metrics.enabled():
        return
    _obs_metrics.counter("collective_calls_total",
                         "collective ops (per trace when jitted)"
                         ).inc(op=op)
    ts = x if isinstance(x, (list, tuple)) else [x]
    nbytes = sum(int(t.numel()) * t.element_size() for t in ts
                 if isinstance(t, torch.Tensor))
    _obs_metrics.counter("collective_bytes_total",
                         "payload bytes handed to collectives "
                         "(per trace when jitted)").inc(nbytes, op=op)


# ring_id -> group registry (the reference's NCCLCommContext by ring id)
_groups: Dict[int, "CommGroup"] = {}


class CommGroup:
    """A named communicator (one NCCL ring): mesh axes, or a process
    group."""

    def __init__(self, ring_id: int, axis) -> None:
        self.ring_id = ring_id
        self.axis = axis

    def __repr__(self) -> str:
        return f"CommGroup(ring_id={self.ring_id}, axis={self.axis!r})"


def new_group(axis, ring_id: Optional[int] = None) -> CommGroup:
    """Registers a communicator over mesh axes (or a process group)."""
    rid = ring_id if ring_id is not None else (max(_groups) + 1
                                               if _groups else 0)
    g = CommGroup(rid, axis)
    _groups[rid] = g
    return g


def get_group(ring_id: int = 0) -> CommGroup:
    if ring_id not in _groups:
        _groups[ring_id] = CommGroup(ring_id, "dp")
    return _groups[ring_id]


def resolve(group=None):
    """The process group a ``group=`` argument names, or None for the
    identity world (no process group, or a rank outside the mesh)."""
    if not _env.is_initialized():
        return None
    axis = get_group(0).axis if group is None else group
    if isinstance(axis, CommGroup):
        axis = axis.axis
    if isinstance(axis, dist.ProcessGroup):
        return axis
    m = _mesh.current_mesh()
    if m is None:
        return dist.group.WORLD
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if any(a not in m.shape for a in axes):
        raise ValueError(f"group {axis!r}: the mesh {m.shape} has no "
                         f"such axis")
    return m.group(axes)


def _size(pg) -> int:
    return 1 if pg is None else dist.get_world_size(pg)


def _staged(pg, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through a host copy: a CUDA tensor under Gloo."""
    be = dist.get_backend(pg)
    if be == "gloo":
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"collective: Gloo takes CPU or (staged) "
                             f"CUDA tensors, not {t.device}")
        return t.device.type == "cuda"
    if be == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"collective: NCCL takes CUDA tensors, not "
                             f"{t.device}; use a Gloo group for CPU "
                             f"tensors")
        return False
    raise ValueError(f"collective: backend {be!r} is not supported")


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


# host calls into the backend, by backend (read by chip_smoke.py: a
# captured step's NCCL calls are those its capture recorded)
_backend_calls: Dict[str, int] = {}


def backend_calls() -> Dict[str, int]:
    return dict(_backend_calls)


def reset_backend_calls() -> None:
    _backend_calls.clear()


def _run(pg, fn, out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """``fn(out, *inputs)`` (a torch collective writing ``out``) on the
    right device for ``pg``'s backend; returns ``out``."""
    be = dist.get_backend(pg)
    _backend_calls[be] = _backend_calls.get(be, 0) + 1
    if not _staged(pg, out):
        fn(out, *inputs)
        return out
    hout = _host(out)
    fn(hout, *(_host(t) for t in inputs))
    out.copy_(hout)
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PRODUCT,
        "mean": dist.ReduceOp.SUM}


def _all_reduce_raw(x: torch.Tensor, op: str, pg) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    _run(pg, lambda o: dist.all_reduce(o, op=_OPS[op], group=pg), out)
    if op == "mean":
        out = out / _size(pg)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, pg):
        ctx.op, ctx.pg = op, pg
        return _all_reduce_raw(x, op, pg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.op, ctx.pg), None, None


def all_reduce(x: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The reduction of ``x`` over the group (sum, mean, max, min, prod)
    on every rank. Differentiable for sum and mean."""
    pg = resolve(group)
    if pg is None:
        return x
    if op not in _OPS:
        raise ValueError(f"unknown reduce op '{op}'")
    _account("all_reduce", x)
    if op in ("sum", "mean") and x.requires_grad:
        return _AllReduce.apply(x, op, pg)
    return _all_reduce_raw(x, op, pg)


def _gather_raw(x: torch.Tensor, axis: int, pg) -> torch.Tensor:
    n = _size(pg)
    src = x.detach().movedim(axis, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _run(pg, lambda o, i: dist.all_gather_into_tensor(o, i, group=pg),
         out, src)
    return out.movedim(0, axis)


def _scatter_raw(x: torch.Tensor, axis: int, pg) -> torch.Tensor:
    n = _size(pg)
    src = x.detach().movedim(axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {axis} ({src.shape[0]}) "
                         f"does not split over {n} ranks")
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _run(pg, lambda o, i: dist.reduce_scatter_tensor(
        o, i, op=dist.ReduceOp.SUM, group=pg), out, src)
    return out.movedim(0, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, pg):
        ctx.axis, ctx.pg = axis, pg
        return _gather_raw(x, axis, pg)

    @staticmethod
    def backward(ctx, g):
        return _scatter_raw(g, ctx.axis, ctx.pg), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, pg):
        ctx.axis, ctx.pg = axis, pg
        return _scatter_raw(x, axis, pg)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.axis, ctx.pg), None, None


def all_gather(x: torch.Tensor, axis: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order
    (``lax.all_gather(tiled=True)``); backward: reduce-scatter."""
    pg = resolve(group)
    if pg is None:
        return x
    _account("all_gather", x)
    return _AllGather.apply(x, axis, pg)


def reduce_scatter(x: torch.Tensor, axis: int = 0,
                   group=None) -> torch.Tensor:
    """The sum over ranks, each rank keeping its block of ``axis``
    (``lax.psum_scatter(tiled=True)``); backward: all-gather."""
    pg = resolve(group)
    if pg is None:
        return x
    _account("reduce_scatter", x)
    return _ReduceScatter.apply(x, axis, pg)


def _group_src(pg, src: int) -> int:
    return dist.get_global_rank(pg, src)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s (index within the group) ``x`` on every rank."""
    pg = resolve(group)
    if pg is None:
        return x
    _account("broadcast", x)
    out = x.detach().clone().contiguous()
    gsrc = _group_src(pg, src)
    return _run(pg, lambda o: dist.broadcast(o, gsrc, group=pg), out)


def reduce(x: torch.Tensor, dst: int = 0, op: str = "sum",
           group=None) -> torch.Tensor:
    """The reduction, valid on ``dst``; every rank gets it, as in the JAX
    package (an all-reduce)."""
    return all_reduce(x, op, group)


def scatter(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Each rank's block (by its index in the group) of dim 0 of rank
    ``src``'s ``x``."""
    pg = resolve(group)
    if pg is None:
        return x
    _account("scatter", x)
    n = _size(pg)
    full = x.detach().clone().contiguous()
    gsrc = _group_src(pg, src)
    _run(pg, lambda o: dist.broadcast(o, gsrc, group=pg), full)
    size = full.shape[0] // n
    return full.narrow(0, dist.get_rank(pg) * size, size).clone()


def _a2a_raw(x: torch.Tensor, split_axis: int, concat_axis: int,
             pg) -> torch.Tensor:
    n = _size(pg)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} "
                         f"({x.shape[split_axis]}) does not split over "
                         f"{n} ranks")
    # block j of split_axis goes to rank j: stack the blocks on a new
    # leading dim, exchange, and lay what came from rank j as block j of
    # concat_axis
    blocks = torch.stack(x.detach().chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(blocks)
    _run(pg, lambda o, i: dist.all_to_all_single(o, i, group=pg), out,
         blocks)
    out = out.movedim(0, concat_axis)
    shape = list(x.shape)
    shape[split_axis] //= n
    shape[concat_axis] *= n
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, pg):
        ctx.args = (split_axis, concat_axis, pg)
        return _a2a_raw(x, split_axis, concat_axis, pg)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis, pg = ctx.args
        return _a2a_raw(g, concat_axis, split_axis, pg), None, None, None


def all_to_all(x: torch.Tensor, split_axis: int = 0, concat_axis: int = 0,
               group=None) -> torch.Tensor:
    """Block j of ``split_axis`` to rank j; what rank j sent becomes block
    j of ``concat_axis`` (``lax.all_to_all(tiled=True)``; Ulysses'
    sequence <-> head exchange). Backward: the swapped exchange."""
    pg = resolve(group)
    if pg is None:
        return x
    _account("all_to_all", x)
    return _AllToAll.apply(x, split_axis, concat_axis, pg)


def _perm_raw(x: torch.Tensor, perm: Tuple[Tuple[int, int], ...],
              pg) -> torch.Tensor:
    n = _size(pg)
    me = dist.get_rank(pg)
    dst = {s: d for s, d in perm}
    src = {d: s for s, d in perm}
    numel = x.numel()
    flat = x.detach().contiguous().reshape(-1)
    # a split list must sum to its tensor's length: a rank that sends (or
    # receives) nothing hands an empty tensor
    send = flat if me in dst else flat[:0]
    recv = torch.empty(numel if me in src else 0, dtype=x.dtype,
                       device=x.device)
    in_splits = [numel if dst.get(me) == j else 0 for j in range(n)]
    out_splits = [numel if src.get(me) == j else 0 for j in range(n)]
    _run(pg, lambda o, i: dist.all_to_all_single(
        o, i, out_splits, in_splits, group=pg), recv, send)
    if me not in src:
        return torch.zeros_like(x)
    return recv.reshape(x.shape)


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, pg):
        ctx.perm, ctx.pg = perm, pg
        return _perm_raw(x, perm, pg)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _perm_raw(g, inv, ctx.pg), None, None


def ppermute(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """Sends this rank's ``x`` along ``perm`` (pairs ``(src, dst)`` of
    group indices); a rank nothing is sent to gets zeros. The ring
    attention shift. Backward: the inverse permutation."""
    pg = resolve(group)
    if pg is None:
        return x
    _account("ppermute", x)
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _Permute.apply(x, perm, pg)


def barrier(group=None) -> torch.Tensor:
    """Waits for every rank of the group; returns ``ones(())``."""
    pg = resolve(group)
    if pg is not None:
        dist.barrier(group=pg)
    return torch.ones(())


def rank(group=None) -> torch.Tensor:
    """This rank's index in the group (int32, 0 outside a group)."""
    pg = resolve(group)
    return torch.tensor(0 if pg is None else dist.get_rank(pg),
                        dtype=torch.int32)


def world_size(group=None) -> int:
    return _size(resolve(group))
