"""The sharded training step.

Counterpart of ``paddle_tpu.parallel.spmd``: ``ShardedTrainStep`` with the
JAX arguments (``batch_spec``, ``param_rule``, ``zero_stage`` 0-3,
``dp_axis``, ``amp_dtype``, ``scaler``, ``extra_metrics``, ``seed``),
``make_param_specs``, ``megatron_param_rule``, ``host_lr_of``/
``inject_host_lr``, ``split_kwargs_by_shardable`` (with its one-time
note) and ``leading_batch_size``.

**The contract.** The JAX step compiles ONE program over the mesh whose
result is the single-device ``TrainStep``'s on the global batch; the
sharding moves bytes, not numbers. The port runs one process per rank, so
the global meaning is restored explicitly:

- Every rank is called with the GLOBAL batch, as the JAX step is, and
  keeps its own rows: a leaf the ``batch_spec`` splits (dim 0 over the
  spec's axes, divisible) is cut to this rank's block; a leaf it cannot
  split is kept whole (replicated), as ``_place_batch`` does. Labels stay
  global. A batch whose first input does not split (a tail batch) runs
  whole on every rank: nothing is gathered or reduced.
- The model runs on this rank's rows. Its outputs that are per-row (a
  tensor whose leading dim is this rank's row count, and that is not a
  parameter) are all-gathered over the batch axes into the global
  outputs, and the loss and ``extra_metrics`` are computed on those and
  the global labels, so the reported loss, the metrics, and a mean over a
  count that varies by rank (a masked-LM loss with ``ignore_index``) are
  the global ones. The gather's backward hands each rank the cotangent
  of its own rows (every rank computes the same global loss), so a
  rank's gradient is the global loss's gradient through its rows, and the
  sum of the ranks' gradients, one all-reduce over the batch axes per
  gradient dtype (a flat bucket each), is the gradient of the global
  loss. An output that is not per-row and carries a gradient (a
  parameter the model hands to its loss, as BERT's fused MLM head hands
  over the tied word embedding and the decoder bias) is the same on
  every rank, and so is its cotangent, the global loss's whole one: its
  backward keeps 1 / (rank count) of it, so that the sum counts it
  once.
- A BatchNorm in the model normalises over the global batch
  (``nn.norm.global_batch``, set around the forward when the batch is
  split over more than one rank), as the JAX program's BatchNorm sees
  the whole batch; ``SyncBatchNorm`` reduces over its own axis.
- Placement changes where bytes live, never the numbers. The model
  holds this rank's BLOCK of every partitioned parameter (its
  ``named_parameters()``, ``state_dict()`` and the step's ``params`` are
  the blocks), and the work is partitioned with it:

  - **Tensor parallelism** (a ``param_rule`` such as
    :func:`megatron_param_rule`). A Linear weight the rule splits over
    its output columns (``P(None, "mp")``: ``q_proj``/``k_proj``/
    ``v_proj``, ``linear1``, ``fc1``) is held and multiplied as this
    rank's block of columns, with the matching block of its bias; its
    row-parallel partner (``P("mp", None)``: ``out_proj``, ``linear2``,
    ``fc2``) as this rank's block of input rows, its bias whole. Around
    each pair sit the Megatron collectives over ``mp``: an identity
    forward whose backward all-reduces (``_CopyToMP``, on the
    attention's inputs and on ``linear1``/``fc1``'s input) and an
    all-reduce after the row-parallel product, the bias added after it
    (``_ReduceFromMP``). Attention runs on its local heads,
    ``num_heads / mp`` (the flash kernels see fewer heads). A rule that
    splits any other parameter, or a pair whose layout the model does
    not have (a column weight with no row partner, heads or widths that
    ``mp`` does not divide), raises with the parameter's name. Dropout
    inside a partitioned block draws per local head and column, so a
    tensor-parallel run with dropout is not bit for bit an unpartitioned
    one (the parity checks run without dropout).
  - **ZeRO** (``zero_stage``, over ``dp_axis``; ``_dp_dims``: the
    largest dim of the held block that ``dp`` divides, one that no
    tensor axis splits first, as the JAX ``_zero_shard_spec`` picks).
    Stages 1/2 split the optimizer slots: the optimizer updates this
    rank's ``dp`` block of each (held) parameter and the updated blocks
    are all-gathered into it. Stage 3 splits the parameters themselves:
    between steps a rank holds only its ``dp`` block. Each top-level
    layer (a child of the model, or an element of a ``LayerList``) all-
    gathers its parameters just before its forward (``_Zero3``) and drops
    them after it; a saved-tensor hook keeps no gathered copy for the
    backward and gathers it again when the backward reads it; the
    gradient's adjoint of the gather is a reduce-scatter over ``dp``
    (the sum of the ranks' blocks). A parameter read outside those
    layers (BERT's tied word embedding, handed to the head by the root)
    is gathered where it is read. On the card the step is captured with
    these collectives inside its graph, and the graph's private pool
    holds the transient copies.

  - **Expert parallelism** (:func:`~paddle_tpu_torch.nn.moe_param_rule`:
    a ``MoELayer``'s ``w_in``/``b_in``/``w_out``/``b_out`` split along
    their expert dim over one axis, ``ep``). A rank holds and multiplies
    its ``E / ep`` experts; the tokens stay replicated over ``ep``; the
    layer all-reduces its partial combine over ``ep`` and, backward, the
    cotangents of its input and of its gate weight (``nn/moe.py``'s
    note). Its capacity, slots and ``aux_loss`` count the global batch
    through ``nn.norm.global_batch``, as BatchNorm does. A ``batch_spec``
    that splits the tokens over the expert axis, ZeRO >= 1 beside it, or
    an expert weight split alone or along another dim raises with the
    parameter's name.

  The optimizer updates the held blocks in place; no whole parameter is
  formed for the forward. A ``grad_clip`` still sees the whole gradients
  (gathered for the clip alone, as in the JAX program). The skip verdict
  (scaler or guard) is agreed over the axes the blocks differ on.
  :meth:`ShardedTrainStep.whole_params` all-gathers the whole parameters
  (every rank calls it), for a comparison or a checkpoint of the whole
  model. A parameter with an all-replicated spec is its own shard: no
  copy, no gather. The fused Adam kernel (``fused_adam`` flag) updates
  the blocks in one launch, as it updates whole leaves.
- ``optimizer_fused_state`` (one flat replicated vector) is refused with
  ZeRO or any sharded parameter, as in the JAX package.

``state_dict()``/``set_state_dict()`` are ``TrainStep``'s, over this
rank's blocks: the held parameters and the optimizer slots of the
blocks it updates (buffers and replicated leaves whole).

On the card under NCCL the step is captured as one CUDA graph per input
signature, like ``static.TrainStep``, its collectives inside the graph.
Under Gloo (several ranks sharing one card, or the CPU) the collectives
synchronise with the host, so the step runs eagerly (``compiled=True``
there raises). Without a process group (one process, no
``init_parallel_env``) every collective is the identity and the step is
``TrainStep`` with the placement above.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import amp as _amp
from .. import observability as _obs
from ..convert import tensor_from_numpy
from ..core import random as _random
from ..nn import norm as _norm
from ..optimizer import LRScheduler, Optimizer
from ..optimizer.lr import resolve_lr
from ..static import TrainStep, apply_fault_mults
from . import collective as _c
from . import env as _env
from .mesh import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["ShardedTrainStep", "make_param_specs", "megatron_param_rule",
           "host_lr_of", "inject_host_lr", "split_kwargs_by_shardable",
           "leading_batch_size"]


def make_param_specs(params: Dict[str, Any],
                     rule: Optional[Callable[[str, Any], P]] = None
                     ) -> Dict[str, P]:
    """Default: replicate everything (pure data parallelism). A rule maps
    a parameter's name and value to its spec (e.g. Megatron-style
    column-parallel q/k/v over ``mp``)."""
    if rule is None:
        return {name: P() for name in params}
    return {name: P(*rule(name, value)) for name, value in params.items()}


def megatron_param_rule(mp_axis: str = "mp"):
    """Example tensor-parallel rule: large 2-D matmul weights
    column-wise, their paired output projections row-wise, the rest
    replicated. By name; models can pass their own rule."""

    def rule(name: str, value) -> P:
        shape = getattr(value, "shape", ())
        if len(shape) == 2:
            if any(tag in name for tag in ("q_proj", "k_proj", "v_proj",
                                           "linear1", "fc1")):
                return P(None, mp_axis)
            if any(tag in name for tag in ("out_proj", "linear2", "fc2")):
                return P(mp_axis, None)
        return P()

    return rule


def host_lr_of(optimizer) -> Optional[float]:
    """The current rate of a host-driven scheduler (ReduceOnPlateau), else
    None; host state only, no device read."""
    sched = getattr(optimizer, "learning_rate", None)
    if isinstance(sched, LRScheduler) and getattr(sched, "host_driven",
                                                  False):
        return float(sched.get_lr())
    return None


def inject_host_lr(batch: Dict[str, Any], optimizer) -> Dict[str, Any]:
    """Puts a host-driven scheduler's live rate into ``batch["lr"]`` (an
    fp32 scalar tensor), as the JAX steps feed it in."""
    lr = host_lr_of(optimizer)
    if lr is not None:
        batch["lr"] = torch.tensor(lr, dtype=torch.float32)
    return batch


_shardable_warned: set = set()
_note_counts: Dict[str, int] = {}
_MAX_NOTES_PER_NAME = 2


def _note_auto_shard(name: str, shape, rule: str) -> None:
    """Says once per (name, shape), at most twice per name, that a
    model-forward kwarg was classified as per-sample data: the
    classification is a convention that cannot be checked (a replicated
    table whose dims merely coincide would be split wrong). Logged, not
    warned, as in the JAX package."""
    key = (name, tuple(shape))
    if key in _shardable_warned \
            or _note_counts.get(name, 0) >= _MAX_NOTES_PER_NAME:
        return
    _shardable_warned.add(key)
    _note_counts[name] = _note_counts.get(name, 0) + 1
    logging.getLogger("paddle_tpu_torch.parallel").warning(
        "model-forward kwarg '%s' (shape %s) auto-classified as "
        "per-sample data (%s); it will be batch-sharded/micro-sliced. "
        "If it is actually replicated (a table/mask whose dims "
        "coincide), give it a non-batch leading dim, e.g. reshape to "
        "[1, ...].", name, tuple(shape), rule)


def split_kwargs_by_shardable(kwargs: Dict[str, Any],
                              batch_size: Optional[int],
                              note: bool = True):
    """``(shardable, replicated)`` model-forward kwargs: a leaf whose
    leading dim equals the batch size is per-sample data; everything else
    (masks, tables, scalars) is replicated. Each classification as data
    is noted once per name (``note=False`` on a size-1 mesh)."""
    sh, rep = {}, {}
    for n, v in kwargs.items():
        nd = getattr(v, "ndim", None)
        shp = getattr(v, "shape", None)
        if nd is None and hasattr(v, "__len__"):
            v = np.asarray(v)
            nd, shp = v.ndim, v.shape
        if (batch_size is not None and nd and shp
                and shp[0] == batch_size):
            if note:
                _note_auto_shard(n, shp, "leading dim equals the "
                                         f"batch size {batch_size}")
            sh[n] = v
        else:
            rep[n] = v
    return sh, rep


def leading_batch_size(args, labels) -> Optional[int]:
    """The batch size from the first arg (else the first label)."""
    lead = args[0] if args else (labels[0] if labels else None)
    if getattr(lead, "ndim", 0) >= 1:
        return lead.shape[0]
    return None


Dims = List[Tuple[int, str]]


def _sharded_dims(spec: P, mesh: Mesh) -> List[Tuple[int, Any]]:
    """(dim, axes) of each dim of ``spec`` split over more than one
    rank."""
    return [(d, e) for d, e in enumerate(spec)
            if e is not None and mesh.axis_size(e) > 1]


def _dp_dims(held: Dims, shape, mesh: Mesh, axis: str) -> Dims:
    """ZeRO's split of a parameter of ``shape`` held as the blocks
    ``held``: ``[(dim, axis)]`` for the largest dim of the held block
    that the ``axis`` size divides, preferring a dim no other axis splits
    (the JAX ``_zero_shard_spec``'s choice); ``[]`` when none divides or
    ``axis`` already splits it."""
    n = mesh.shape.get(axis, 1)
    if n <= 1 or not len(shape) or any(a == axis for _, a in held):
        return []
    local = list(shape)
    for d, a in held:
        local[d] //= mesh.axis_size(a)
    taken = {d for d, _ in held}
    for free in (True, False):
        cand = [(local[d], d) for d in range(len(local))
                if local[d] % n == 0 and (d not in taken or not free)]
        if cand:
            return [(max(cand)[1], axis)]
    return []


def _spec_of(dims: Dims, ndim: int) -> P:
    """The spec of a block split as ``dims`` (applied in order: a dim
    split twice is a tuple entry, major axis first)."""
    entries: List[Any] = [None] * ndim
    for d, a in dims:
        entries[d] = a if entries[d] is None else (
            (entries[d] if isinstance(entries[d], tuple) else
             (entries[d],)) + (a,))
    return P(*entries)


def _block(t: torch.Tensor, dims, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` (a view), the dims split in order."""
    for d, e in dims:
        size = t.shape[d] // mesh.axis_size(e)
        t = t.narrow(d, mesh.axis_index(e) * size, size)
    return t


def _unblock(t: torch.Tensor, dims, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``t`` (all-gathers, the
    dims in reverse order)."""
    for d, e in reversed(dims):
        t = _c._gather_raw(t, d, mesh.group(e))
    return t


# -- tensor parallelism -------------------------------------------------------

class _CopyToMP(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce backward over the
    tensor axis (the input of a column-parallel product reaches every
    rank's block; its cotangent is the sum of theirs)."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _c._account("all_reduce", g)
        return _c._all_reduce_raw(g, "sum", ctx.pg), None


class _ReduceFromMP(torch.autograd.Function):
    """Megatron's ``g``: all-reduce forward over the tensor axis (the
    row-parallel partial products summed), identity backward."""

    @staticmethod
    def forward(ctx, x, pg):
        _c._account("all_reduce", x)
        return _c._all_reduce_raw(x, "sum", pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _row_parallel_forward(self, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel Linear: this rank's rows of ``W`` times its block
    of ``x``'s columns, summed over the tensor axis, then the bias."""
    y = _ReduceFromMP.apply(torch.matmul(x, self.weight), self._pt_mp_group)
    return y if self.bias is None else y + self.bias


_DERIVED: Dict[tuple, type] = {}


def _derived_class(cls: type, tag: str, namespace: Dict[str, Any]) -> type:
    """A subclass of ``cls`` with ``namespace`` (one per class and tag),
    keeping the class's name: a module's class is swapped for it."""
    key = (cls, tag)
    if key not in _DERIVED:
        sub = type(cls.__name__, (cls,), dict(namespace,
                                              __module__=cls.__module__))
        sub.__qualname__ = cls.__qualname__
        _DERIVED[key] = sub
    return _DERIVED[key]


def _copy_inputs_hook(pg):
    """A forward pre-hook applying ``_CopyToMP`` to the module's tensor
    inputs (the attention's query/key/value: one ``f`` a distinct
    tensor)."""

    def hook(module, args, kwargs):
        seen: Dict[int, torch.Tensor] = {}

        def f(x):
            if not isinstance(x, torch.Tensor) or not x.is_floating_point():
                return x
            if id(x) not in seen:
                seen[id(x)] = _CopyToMP.apply(x, pg)
            return seen[id(x)]

        names = ("query", "key", "value")
        args = tuple(f(a) if i < 3 else a for i, a in enumerate(args))
        kwargs = {k: f(v) if k in names else v for k, v in kwargs.items()}
        return args, kwargs

    return hook


_COLUMN_PAIRS = {"linear1": "linear2", "fc1": "fc2"}
_EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")
_ATTN_COLUMNS = ("q_proj", "k_proj", "v_proj")


def _plan_tensor_parallel(model: nn.Module, specs: Dict[str, P],
                          mesh: Mesh) -> Tuple[Dict[str, Dims], list]:
    """The tensor-parallel blocks of the parameters ``specs`` split
    (``{name: [(dim, axis)]}``, a column weight's bias included) and the
    module changes that partition the work, after checking that every
    split parameter belongs to a Megatron pair the model has (ValueError
    naming the parameter otherwise)."""
    from ..nn.layers import Linear
    from ..nn.moe import MoELayer
    from ..nn.transformer import MultiHeadAttention
    mods = dict(model.named_modules())
    split = {n: _sharded_dims(s, mesh) for n, s in specs.items()}
    split = {n: d for n, d in split.items() if d}
    held: Dict[str, Dims] = {}
    roles: Dict[str, Tuple[str, str]] = {}  # module -> (role, axis)

    def bad(name: str, why: str) -> ValueError:
        return ValueError(
            f"ShardedTrainStep: the param_rule splits '{name}' "
            f"({specs[name]}), but {why}; the port partitions the "
            f"Megatron pairs (q/k/v_proj + out_proj of a "
            f"MultiHeadAttention, linear1 + linear2, fc1 + fc2) and a "
            f"MoELayer's experts (w_in, b_in, w_out, b_out over their "
            f"expert dim), no other parameter")

    experts: Dict[str, str] = {}  # MoELayer -> its expert axis
    for name, dims in split.items():
        mname, _, pname = name.rpartition(".")
        mod = mods.get(mname)
        if isinstance(mod, MoELayer) and pname in _EXPERT_LEAVES:
            if dims[0][0] != 0 or len(dims) != 1 \
                    or not isinstance(dims[0][1], str):
                raise bad(name, "an expert weight is split over one axis "
                                "along its expert dim alone")
            if experts.setdefault(mname, dims[0][1]) != dims[0][1]:
                raise bad(name, "its MoELayer's expert weights are split "
                                "over different axes")
            continue
        if pname == "bias" and isinstance(mod, Linear):
            continue  # checked with its weight below
        if not isinstance(mod, Linear) or pname != "weight":
            raise bad(name, "it is not a Linear's weight")
        if len(dims) != 1 or not isinstance(dims[0][1], str):
            raise bad(name, "it is split over more than one axis")
        d, axis = dims[0]
        roles[mname] = ("column" if d == 1 else "row", axis)
    for name, dims in split.items():
        mname, _, pname = name.rpartition(".")
        if mname in experts:
            continue
        if pname == "bias" and (mname not in roles
                                or roles[mname][0] != "column"
                                or dims != [(0, roles[mname][1])]):
            raise bad(name, "only a column-parallel Linear's bias is "
                            "split, with its weight's columns")
    actions: list = []
    for mname, axis in experts.items():
        moe, k = mods[mname], mesh.axis_size(axis)
        for leaf in _EXPERT_LEAVES:
            wname = f"{mname}.{leaf}"
            if wname not in split:
                raise bad(f"{mname}.w_in", f"'{wname}' is not split with "
                                           f"it: the experts' four weights "
                                           f"split together")
            held[wname] = [(0, axis)]
        if moe.num_experts % k:
            raise bad(f"{mname}.w_in", f"{moe.num_experts} experts do not "
                                       f"split over {k} ranks")
        actions.append(("experts", moe, axis))
    for mname, (role, axis) in roles.items():
        parent, _, leaf = mname.rpartition(".")
        prefix = parent + "." if parent else ""
        k = mesh.axis_size(axis)
        lin = mods[mname]
        wname = f"{prefix}{leaf}.weight"
        if leaf in _ATTN_COLUMNS or leaf == "out_proj":
            mha = mods.get(parent)
            want = {f"{prefix}{c}": ("column", axis) for c in _ATTN_COLUMNS}
            want[f"{prefix}out_proj"] = ("row", axis)
            if not isinstance(mha, MultiHeadAttention) or any(
                    roles.get(m) != r for m, r in want.items()):
                raise bad(wname, "its MultiHeadAttention does not split "
                                 "q/k/v_proj by columns and out_proj by "
                                 "rows over one axis")
            if mha.num_heads % k:
                raise bad(wname, f"{mha.num_heads} heads do not split "
                                 f"over {k} ranks")
            if leaf == "out_proj":
                actions.append(("attention", mha, axis))
        elif leaf in _COLUMN_PAIRS or leaf in _COLUMN_PAIRS.values():
            col = leaf if leaf in _COLUMN_PAIRS else next(
                c for c, r in _COLUMN_PAIRS.items() if r == leaf)
            pair = {f"{prefix}{col}": ("column", axis),
                    f"{prefix}{_COLUMN_PAIRS[col]}": ("row", axis)}
            if any(roles.get(m) != r for m, r in pair.items()):
                raise bad(wname, f"its pair {sorted(pair)} is not split "
                                 f"column then row over one axis")
            if role == "column":
                actions.append(("input", lin, axis))
        else:
            raise bad(wname, "it has no Megatron partner")
        width = lin.out_features if role == "column" else lin.in_features
        if width % k:
            raise bad(wname, f"its width {width} does not split over {k} "
                             f"ranks")
        held[wname] = [(1 if role == "column" else 0, axis)]
        if role == "column" and lin.bias is not None:
            held[f"{prefix}{leaf}.bias"] = [(0, axis)]
        actions.append((role, lin, axis))
    return held, actions


def _apply_tensor_parallel(actions: list, mesh: Mesh) -> None:
    """Partitions the work (see :func:`_plan_tensor_parallel`)."""
    for kind, mod, axis in actions:
        k, pg = mesh.axis_size(axis), mesh.group(axis)
        if kind == "experts":
            mod._pt_ep = (pg, mesh.axis_index(axis), k)
        elif kind == "attention":
            mod.num_heads //= k
            mod.embed_dim //= k
            mod.register_forward_pre_hook(_copy_inputs_hook(pg),
                                          with_kwargs=True)
        elif kind == "input":
            mod.register_forward_pre_hook(_copy_inputs_hook(pg),
                                          with_kwargs=True)
        elif kind == "column":
            mod.out_features //= k
        else:
            mod.in_features //= k
            mod._pt_mp_group = pg
            mod.__class__ = _derived_class(
                type(mod), "row", {"forward": _row_parallel_forward})


def _check_experts(actions: list, held: Dict[str, Dims], batch_spec: P,
                   mesh: Mesh, zero_stage: int) -> None:
    """Expert parallelism runs with the tokens replicated over the expert
    axis and without ZeRO; any other combination raises, naming an
    expert parameter."""
    axes = {a for kind, _, a in actions if kind == "experts"}
    if not axes:
        return
    name = next(n for n, d in held.items() if d and d[0][1] in axes)
    lead = tuple(batch_spec)[0] if len(batch_spec) else None
    lead = () if lead is None else (lead,) if isinstance(lead, str) \
        else tuple(lead)
    if axes & set(lead):
        raise ValueError(
            f"ShardedTrainStep: the param_rule splits '{name}' over "
            f"{sorted(axes)}, and the batch_spec {batch_spec} splits the "
            f"tokens over it too; the port's expert parallelism keeps the "
            f"tokens replicated over the expert axis")
    if zero_stage >= 1:
        raise ValueError(
            f"ShardedTrainStep: the param_rule splits '{name}' over "
            f"{sorted(axes)}; the port's expert parallelism does not "
            f"combine with ZeRO (zero_stage={zero_stage}): use "
            f"zero_stage=0")


# -- ZeRO 3: parameters gathered on use ----------------------------------------

class _ZeroGather(torch.autograd.Function):
    """A parameter's ``dp`` block all-gathered along ``dim``; backward:
    the reduce-scatter of the whole cotangent (times ``scale``: 1 / dp
    for a batch every rank ran whole). The node keeps the block, so a
    saved-tensor hook can gather it again."""

    @staticmethod
    def forward(ctx, shard, dim, pg, scale):
        ctx.shard, ctx.dim, ctx.pg, ctx.scale = shard, dim, pg, scale
        _c._account("all_gather", shard)
        return _c._gather_raw(shard, dim, pg).contiguous()

    @staticmethod
    def backward(ctx, g):
        _c._account("reduce_scatter", g)
        out = _c._scatter_raw(g, ctx.dim, ctx.pg).contiguous()
        if ctx.scale != 1.0:
            out = out * ctx.scale
        return out, None, None, None


_ZERO_NODE = _ZeroGather._backward_cls


class _Zero3:
    """ZeRO 3's gather on use (see the module note): the modules holding
    a ``dp`` block read the parameter through a class property that
    returns the gathered whole (cached while the enclosing top-level
    layer runs its forward), and :meth:`pack`/:meth:`unpack` replace a
    saved gathered parameter (or a view of one) by a token that gathers
    it again in the backward."""

    def __init__(self, mesh: Mesh, axis: str) -> None:
        self.pg = mesh.group(axis)
        self.scale = 1.0
        self.cache: Dict[Tuple[int, str], torch.Tensor] = {}

    def gather(self, mod: nn.Module, name: str) -> torch.Tensor:
        key = (id(mod), name)
        t = self.cache.get(key)
        if t is None:
            dim = mod.__dict__["_pt_zero3_dims"][name]
            t = _ZeroGather.apply(mod._parameters[name], dim, self.pg,
                                  self.scale)
        return t

    def enter(self, entries) -> None:
        for mod, name in entries:
            self.cache[(id(mod), name)] = self.gather(mod, name)

    def exit(self, entries) -> None:
        for mod, name in entries:
            self.cache.pop((id(mod), name), None)

    @staticmethod
    def pack(t: torch.Tensor):
        if type(t.grad_fn) is _ZERO_NODE:
            return (t.grad_fn,)
        base = t._base
        if base is not None and type(base.grad_fn) is _ZERO_NODE:
            return (base.grad_fn, tuple(t.shape), t.stride(),
                    t.storage_offset() - base.storage_offset())
        return t

    @staticmethod
    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        node = packed[0]
        _c._account("all_gather", node.shard)
        whole = _c._gather_raw(node.shard.detach(), node.dim,
                               node.pg).contiguous()
        return whole if len(packed) == 1 else whole.as_strided(*packed[1:])


def _zero3_property(name: str) -> property:
    def get(self):
        return self.__dict__["_pt_zero3"].gather(self, name)
    return property(get)


def _layer_units(model: nn.Module) -> List[nn.Module]:
    """The top-level layers ZeRO 3 gathers a layer at a time: the model's
    children, each one holding a ``ModuleList`` (or being one) opened
    into its children."""
    units = []

    def visit(m: nn.Module) -> None:
        for child in m.children():
            if isinstance(child, nn.ModuleList) or any(
                    isinstance(d, nn.ModuleList) for d in child.modules()):
                visit(child)
            else:
                units.append(child)

    visit(model)
    return units


def _apply_zero3(model: nn.Module, dims: Dict[int, int],
                 state: _Zero3) -> None:
    """Makes every module holding a ``dp`` block (``dims``: ``id`` of the
    block parameter -> its gathered dim) read it through ``state``, and
    each top-level layer gather its blocks around its forward."""
    by_mod: Dict[nn.Module, Dict[str, int]] = {}
    for mod in model.modules():
        for pname, p in mod._parameters.items():
            if p is not None and id(p) in dims:
                by_mod.setdefault(mod, {})[pname] = dims[id(p)]
    for mod, names in by_mod.items():
        mod.__dict__["_pt_zero3"] = state
        mod.__dict__["_pt_zero3_dims"] = names
        mod.__class__ = _derived_class(
            type(mod), "zero3:" + ",".join(sorted(names)),
            {n: _zero3_property(n) for n in names})
    for unit in _layer_units(model):
        entries = [(m, n) for m in unit.modules()
                   for n in by_mod.get(m, {})]
        if entries:
            unit.register_forward_pre_hook(
                lambda _m, _a, e=entries: state.enter(e))
            unit.register_forward_hook(
                lambda _m, _a, _o, e=entries: state.exit(e))


def _hold_blocks(model: nn.Module, held: Dict[str, Dims],
                 mesh: Mesh) -> None:
    """Replaces every partitioned parameter of ``model`` (each place it is
    registered) by a new parameter holding this rank's block."""
    named = dict(model.named_parameters())
    new: Dict[int, nn.Parameter] = {}
    for name, dims in held.items():
        if dims:
            old = named[name]
            p = nn.Parameter(_block(old.detach(), dims, mesh).clone(
                memory_format=torch.contiguous_format),
                requires_grad=old.requires_grad)
            p.__dict__.update(old.__dict__)  # need_clip, regularizer
            new[id(old)] = p
    for mod in model.modules():
        for pname, p in list(mod._parameters.items()):
            if p is not None and id(p) in new:
                mod._parameters[pname] = new[id(p)]


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_tree_map(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return tree


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 whose backward keeps this rank's rows of the
    cotangent: every rank computes the same global loss from the
    gathered tensor, so its own rows' cotangent is its share."""

    @staticmethod
    def forward(ctx, x, pg, index):
        ctx.rows, ctx.index = x.shape[0], index
        return _c._gather_raw(x, 0, pg)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows), None, None


class _ShareGrad(torch.autograd.Function):
    """Identity whose backward divides the cotangent by the rank count:
    for an output every rank holds whole (a parameter the model returns,
    as BERT's fused MLM head returns the tied word embedding), each rank's
    cotangent is the global loss's whole one, so the ranks' sum would
    count it once per rank; each rank keeps its share instead."""

    @staticmethod
    def forward(ctx, x, count):
        ctx.count = count
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.count, None


class ShardedTrainStep(TrainStep):
    """``step = ShardedTrainStep(model, opt, loss_fn, mesh)``; ``step(*args,
    labels=(...), **kwargs)`` with the GLOBAL batch on every rank runs one
    step of the contract in the module note and returns ``{"loss": ...,
    <extra metrics>}`` (0-d device tensors, global values)."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, mesh: Mesh, batch_spec: P = P("dp"),
                 param_rule: Optional[Callable] = None, seed: int = 0,
                 extra_metrics: Optional[Dict[str, Callable]] = None,
                 zero_stage: int = 0, dp_axis: str = "dp",
                 amp_dtype=None, scaler=None,
                 compiled: Optional[bool] = None) -> None:
        self.mesh = mesh
        self.batch_spec = P(*batch_spec)
        self.axis = dp_axis  # the straggler detector's exchange axis
        self.zero_stage = int(zero_stage)
        if any(e is not None for e in tuple(self.batch_spec)[1:]):
            raise NotImplementedError(
                f"ShardedTrainStep: batch_spec {self.batch_spec} splits a "
                f"dim other than the leading one; the port splits the "
                f"batch by rows only")
        lead = tuple(self.batch_spec)[0] if len(self.batch_spec) else None
        self._batch_axes = lead
        # the gradients' all-reduce runs whenever the batch axes have a
        # process group, one rank included (a copy: a one-card NCCL job
        # makes real NCCL calls); the rows' gather and the global
        # BatchNorm only when the rows are split
        self._batch_group = None if lead is None else mesh.group(lead)
        gloo = _env.is_initialized() and _env.backend() == "gloo"
        if compiled and gloo:
            raise ValueError("ShardedTrainStep(compiled=True): Gloo's "
                             "collectives synchronise with the host, which "
                             "a CUDA graph cannot record; use NCCL")
        # the placement, from the whole parameters (see the module note)
        whole = {n: p for n, p in model.named_parameters()
                 if p.requires_grad}
        rule_specs = make_param_specs(whole, param_rule)
        tp_held, tp_actions = _plan_tensor_parallel(model, rule_specs, mesh)
        _check_experts(tp_actions, tp_held, self.batch_spec, mesh,
                       self.zero_stage)
        held = {n: list(tp_held.get(n, [])) for n in whole}
        if self.zero_stage >= 3:
            for n, p in whole.items():
                held[n] += _dp_dims(held[n], p.shape, mesh, dp_axis)
        extra = {n: _dp_dims(held[n], p.shape, mesh, dp_axis)
                 if self.zero_stage >= 1 else [] for n, p in whole.items()}
        sharded = [n for n in whole if held[n]]
        if optimizer._use_fused() and (self.zero_stage >= 1 or sharded):
            raise ValueError(
                "optimizer_fused_state is incompatible with ZeRO "
                f"sharding / sharded params ({sharded[:3]}...)"
                if sharded else
                "optimizer_fused_state is incompatible with ZeRO "
                "slot sharding; construct the optimizer with "
                "fused_state=False for this strategy")
        self.param_specs = {n: _spec_of(held[n], p.ndim)
                            for n, p in whole.items()}
        self.slot_specs = {n: _spec_of(held[n] + extra[n], p.ndim)
                           for n, p in whole.items()}
        self._held, self._extra = held, extra
        # the axes the held blocks differ on (the skip verdict is agreed
        # over them)
        self._block_axes = sorted({a for n in whole for _, a in held[n]})
        _hold_blocks(model, held, mesh)
        _apply_tensor_parallel(tp_actions, mesh)
        self._zero3 = None
        z3 = {n: d for n in whole for d, a in held[n] if a == dp_axis}
        if z3:
            self._zero3 = _Zero3(mesh, dp_axis)
            named = dict(model.named_parameters())
            _apply_zero3(model, {id(named[n]): d for n, d in z3.items()},
                         self._zero3)
        super().__init__(model, optimizer, loss_fn,
                         extra_metrics=extra_metrics, seed=seed,
                         amp_dtype=amp_dtype, scaler=scaler,
                         compiled=False if gloo else compiled)
        self._span_name = f"ShardedTrainStep({type(model).__name__})"
        self.shards: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for n, p in self.params.items():
                self.shards[n] = _block(p.detach(), extra[n], mesh).clone(
                    memory_format=torch.contiguous_format) \
                    if extra[n] else p
        if any(extra.values()):
            self.state = optimizer.init(self.shards)
        self.state_specs = {"params": self.param_specs,
                            "opt": self.slot_specs}
        self.batch_sharding = NamedSharding(mesh, self.batch_spec)
        self._param_ptrs = {p.data_ptr() for p in model.parameters()}
        self._split_rows = False
        self._note_kwargs = self._batch_axes is not None

    # -- the batch ----------------------------------------------------------

    def _rows(self) -> Tuple[int, int]:
        """(this rank's block index, block count) along the batch axes."""
        if self._batch_group is None:
            return 0, 1
        return (self.mesh.axis_index(self._batch_axes),
                self.mesh.axis_size(self._batch_axes))

    def _as_tensor(self, x):
        if isinstance(x, np.ndarray):
            x = tensor_from_numpy(x)
        if isinstance(x, torch.Tensor) and x.device != self.device:
            x = x.to(self.device)
        return x

    def _local(self, x, kwarg_name: Optional[str] = None):
        """This rank's rows of a batch leaf (the leaf itself when the spec
        cannot split it)."""
        x = self._as_tensor(x)
        index, count = self._rows()
        if not isinstance(x, torch.Tensor) or count == 1 or x.ndim == 0 \
                or x.shape[0] % count:
            return x
        if kwarg_name is not None and self._note_kwargs:
            _note_auto_shard(kwarg_name, tuple(x.shape),
                             "dims divisible by the batch spec")
        rows = x.shape[0] // count
        return x.narrow(0, index * rows, rows)

    def shard_batch(self, *arrays):
        """This rank's rows of each array (the JAX call places them on the
        mesh with the batch sharding)."""
        return tuple(self._local(a) for a in arrays)

    def __call__(self, *args, labels=(), **kwargs):
        # whether the batch's rows split over the ranks: a batch they do
        # not divide (a tail batch) runs whole on every rank, as the JAX
        # step replicates a leaf it cannot shard; the local shapes, and so
        # the step's signature, tell the two apart
        first = self._as_tensor(args[0]) if args else None
        count = self._rows()[1]
        self._split_rows = count > 1 and isinstance(first, torch.Tensor) \
            and first.ndim > 0 and first.shape[0] % count == 0
        if self._zero3 is not None:
            # a batch every rank ran whole gives every rank the whole
            # gradient: the reduce-scatter's sum counts it dp times
            self._zero3.scale = 1.0 if self._split_rows or count == 1 \
                else 1.0 / count
        args = tuple(_tree_map(self._local, self._as_tree(a)) for a in args)
        kwargs = {n: _tree_map(lambda x, n=n: self._local(x, n),
                               self._as_tree(v))
                  for n, v in kwargs.items()}
        labels = labels if isinstance(labels, (tuple, list)) else (labels,)
        labels = tuple(_tree_map(self._as_tensor, self._as_tree(y))
                       for y in labels)
        with self.mesh:
            return super().__call__(*args, labels=labels, **kwargs)

    def run_steps(self, *args, labels=(), **kwargs):
        """Not a ``ShardedTrainStep`` method (the JAX class has none):
        call the step once per batch."""
        raise NotImplementedError(
            "ShardedTrainStep has no run_steps (nor has the JAX one); call "
            "the step once per global batch")

    def _as_tree(self, v):
        return self._as_tensor(v) if isinstance(v, np.ndarray) else v

    # -- the step -----------------------------------------------------------

    def _gather_outputs(self, out, local_rows: Optional[int]):
        """The global outputs: every per-row output tensor gathered over
        the batch axes; any other output that carries a gradient keeps
        1 / count of its cotangent (see the module note)."""
        index, count = self._rows()
        if count == 1 or local_rows is None:
            return out

        def gather(t):
            if t.ndim == 0 or t.shape[0] != local_rows \
                    or t.data_ptr() in self._param_ptrs:
                return _ShareGrad.apply(t, count) if t.requires_grad \
                    else t
            _c._account("all_gather", t)
            return _GatherRows.apply(t, self._batch_group, index)

        return _tree_map(gather, out)

    @torch.no_grad()
    def _gather_params(self) -> None:
        """The held parameters from the updated ZeRO 1/2 blocks (each
        slot-only dim gathered over its axis)."""
        for n, p in self.params.items():
            if self._extra[n]:
                p.copy_(_unblock(self.shards[n], self._extra[n], self.mesh))

    @torch.no_grad()
    def whole_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole (its blocks all-gathered over the ranks:
        every rank calls this), name -> tensor on the step's device."""
        return {n: _unblock(p.detach(), self._held[n], self.mesh)
                if self._held[n] else p.detach()
                for n, p in self.params.items()}

    def _reduce_grads(self, grads: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The sum over the batch axes of every gradient: one all-reduce
        of a flat bucket per dtype (none when the batch ran whole on every
        rank: the gradients are the same there). A ZeRO 3 block's
        gradient came reduce-scattered out of its gather already."""
        if self._batch_group is None or (self._rows()[1] > 1
                                         and not self._split_rows):
            return grads
        out = dict(grads)
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for n, g in grads.items():
            if not any(a == self.axis for _, a in self._held[n]):
                by_dtype.setdefault(g.dtype, []).append(n)
        for dt, names in by_dtype.items():
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            _c._account("all_reduce", flat)
            flat = _c._all_reduce_raw(flat, "sum", self._batch_group)
            off = 0
            for n in names:
                k = grads[n].numel()
                out[n] = flat[off:off + k].view(grads[n].shape)
                off += k
        return out

    def _agree(self, found_inf: torch.Tensor) -> torch.Tensor:
        """The skip verdict of any rank whose blocks differ from this
        one's (max over the axes the held blocks split)."""
        if not self._block_axes:
            return found_inf
        f = found_inf.to(torch.float32)
        for a in self._block_axes:
            f = _c._all_reduce_raw(f, "max", self.mesh.group(a))
        return f > 0

    def _forward_grads(self, args, labels, kwargs):
        """``(loss, {name: gradient}, outputs)`` of this rank's rows: the
        forward, the global loss (scaled under a scaler) and its
        gradients before the reduction over the batch axes."""
        gen = self.generator
        amp = _amp.auto_cast(enable=True, dtype=self.amp_dtype) \
            if self.amp_dtype is not None else contextlib.nullcontext()
        first = args[0] if args else None
        local_rows = first.shape[0] if self._split_rows else None
        bn = _norm.global_batch(self._batch_group) \
            if self._split_rows else contextlib.nullcontext()
        saved = torch.autograd.graph.saved_tensors_hooks(
            self._zero3.pack, self._zero3.unpack) \
            if self._zero3 is not None else contextlib.nullcontext()
        with amp, _random.rng_scope(default=gen, dropout=gen), saved:
            with bn:
                out = self._call_model(args, kwargs)
            out = self._gather_outputs(out, local_rows)
            loss = self.loss_fn(out, *labels)
        if self.scaler is not None:
            loss = self.scaler.scale(loss, self.scaler_state)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return loss, grads, out

    def _step(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        gen = self.generator
        scaler = self.scaler
        before = [(b, b.clone()) for b in self.model.buffers()] \
            if scaler is not None or self._skip_guard else []
        loss, grads, out = self._forward_grads(args, labels, kwargs)
        grads = self._reduce_grads(grads)
        loss = loss.detach()
        if self._faults_armed:
            loss, grads = apply_fault_mults(loss, grads, self._grad_mult,
                                            self._loss_mult)
        found_inf = None
        if scaler is not None:
            grads, found_inf = scaler.unscale(grads, self.scaler_state)
            found_inf = self._agree(found_inf)
            loss = loss / self.scaler_state["scale"].to(loss.dtype)
        elif self._skip_guard:
            found_inf = self._agree(~_amp.all_finite(grads))
        metrics = {"loss": loss}
        if self.extra_metrics:
            with torch.no_grad():
                for name, fn in self.extra_metrics.items():
                    metrics[name] = fn(out, *labels)
        if _obs.enabled():
            norms = torch._foreach_norm(
                [g for g in grads.values() if g.is_floating_point()], 2,
                dtype=torch.float32)
            metrics["_pt_gnorm"] = torch.linalg.vector_norm(
                torch.stack(norms))
            if found_inf is not None:
                metrics["_pt_nonfinite"] = found_inf
        ok = None
        if found_inf is not None:
            ok = ~found_inf
            self.nonfinite_steps.add_(found_inf.to(torch.int64))
            with torch.no_grad():
                for buf, old in before:
                    buf.copy_(torch.where(ok, buf, old))
        if self._lr_scaled:
            lr = resolve_lr(self.optimizer.learning_rate,
                            self.state["step"] + 1) * lr
        self._update(grads, ok, lr, gen)
        if scaler is not None:
            scaler.update(self.scaler_state, found_inf)
        return metrics

    def _update(self, grads, ok, lr, gen) -> None:
        """The optimizer on the blocks it owns (see the module note), then
        the held parameters gathered from ZeRO 1/2's blocks."""
        opt = self.optimizer
        if not any(self._extra.values()) and not self._block_axes:
            return super()._update(grads, ok, lr, gen)
        if opt.grad_clip is not None:
            # the clip's norm is over the whole gradients (a held block's
            # gathered for it); the optimizer's own clip of the blocks
            # then scales by 1 up to rounding (no block exceeds what the
            # whole was clipped to)
            from ..optimizer import _as_f32
            grads = {n: _as_f32(g) for n, g in grads.items()}
            meta = opt._param_meta
            sub = {n: _unblock(g, self._held[n], self.mesh)
                   if self._held[n] else g for n, g in grads.items()
                   if meta.get(n, (True, None))[0]}
            if sub:
                for n, g in opt.grad_clip(sub).items():
                    grads[n] = _block(g, self._held[n], self.mesh
                                      ).contiguous() if self._held[n] else g
        shard_grads = {n: _block(g, self._extra[n], self.mesh).contiguous()
                       if self._extra[n] else g for n, g in grads.items()}
        with _random.rng_scope(default=gen):
            opt.apply_gradients(self.shards, shard_grads, self.state, ok,
                                lr_override=lr)
        self._gather_params()

    # -- the model and the state --------------------------------------------

    @torch.no_grad()
    def reset_from_model(self) -> None:
        """Re-reads the model's (held) parameters into the shards (the JAX
        ``reset_from_model`` re-shards the eager model's weights)."""
        super().reset_from_model()
        for n, p in self.params.items():
            if self._extra[n]:
                self.shards[n].copy_(_block(p.detach(), self._extra[n],
                                            self.mesh))
            else:
                self.shards[n] = p
