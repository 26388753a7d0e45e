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
- Placement changes where bytes live, never the numbers. A parameter's
  ``param_rule`` spec (tensor parallelism, e.g. :func:`megatron_param_rule`)
  and ZeRO's ``dp`` extension (``_zero_shard_spec``: stage 1/2 shard the
  optimizer slots, stage 3 the parameters too) give each parameter a
  SHARD: the block of it this rank owns. The optimizer state is made
  over the shards and the update runs on them alone (the gradient's
  block, after the all-reduce; a ``grad_clip`` runs first on the whole
  gradients, as in the JAX program); the updated shards are then
  all-gathered along each sharded dim into the whole parameter the
  forward reads. Stage 3 shards the parameters' owned blocks as well,
  but the port keeps the whole parameters as the forward's working copy
  (gathered after each update, as at stages 1/2: no per-layer gather on
  use), so it saves what stage 1 saves. The forward runs whole on every
  rank of a tensor
  axis (the same rows, the same numbers), so the tensor axis costs
  compute, not correctness. A parameter with an all-replicated spec is
  its own shard: no copy, no gather. The fused Adam kernel (``fused_adam``
  flag) updates the shards in one launch, as it updates whole leaves.
- ``optimizer_fused_state`` (one flat replicated vector) is refused with
  ZeRO or any sharded parameter, as in the JAX package.

``state_dict()``/``set_state_dict()`` are ``TrainStep``'s: a sharded
parameter's optimizer slots are this rank's blocks (whole parameters,
buffers and replicated slots as they are).

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


def _zero_shard_spec(base: P, value, mesh: Mesh, axis: str) -> P:
    """ZeRO spec: ``base`` with its largest still-replicated dim that
    divides by the ``axis`` size sharded over ``axis``."""
    if not hasattr(value, "ndim") or value.ndim == 0:
        return base
    n = mesh.shape[axis] if axis in mesh.shape else 1
    if n <= 1:
        return base
    if any(axis == e or (isinstance(e, tuple) and axis in e)
           for e in base):
        return base
    entries = list(base) + [None] * (value.ndim - len(list(base)))
    cand = [(value.shape[d], d) for d in range(value.ndim)
            if entries[d] is None and value.shape[d] % n == 0]
    if not cand:
        return base
    _, dim = max(cand)
    entries[dim] = axis
    return P(*entries)


def _sharded_dims(spec: P, mesh: Mesh) -> List[Tuple[int, Any]]:
    """(dim, axes) of each dim of ``spec`` split over more than one
    rank."""
    return [(d, e) for d, e in enumerate(spec)
            if e is not None and mesh.axis_size(e) > 1]


def _block(t: torch.Tensor, dims, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` (a view)."""
    for d, e in dims:
        size = t.shape[d] // mesh.axis_size(e)
        t = t.narrow(d, mesh.axis_index(e) * size, size)
    return t


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
        super().__init__(model, optimizer, loss_fn,
                         extra_metrics=extra_metrics, seed=seed,
                         amp_dtype=amp_dtype, scaler=scaler,
                         compiled=False if gloo else compiled)
        self._span_name = f"ShardedTrainStep({type(model).__name__})"
        params = self.params
        param_specs = make_param_specs(params, param_rule)
        if self.zero_stage >= 3:
            param_specs = {n: _zero_shard_spec(s, params[n], mesh, dp_axis)
                           for n, s in param_specs.items()}
        if self.zero_stage >= 1:
            slot_specs = {n: _zero_shard_spec(param_specs[n], params[n],
                                              mesh, dp_axis)
                          for n in params}
        else:
            slot_specs = param_specs
        self.param_specs = param_specs
        self.slot_specs = slot_specs
        self._dims = {n: _sharded_dims(slot_specs[n], mesh) for n in params}
        sharded = [n for n, s in param_specs.items()
                   if _sharded_dims(s, mesh)]
        if "fused" in self.state and (self.zero_stage >= 1 or sharded):
            raise ValueError(
                "optimizer_fused_state is incompatible with ZeRO "
                f"sharding / sharded params ({sharded[:3]}...)"
                if sharded else
                "optimizer_fused_state is incompatible with ZeRO "
                "slot sharding; construct the optimizer with "
                "fused_state=False for this strategy")
        self.shards: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for n, p in params.items():
                self.shards[n] = _block(p.detach(), self._dims[n],
                                        mesh).clone() if self._dims[n] \
                    else p
        if any(self._dims.values()):
            self.state = optimizer.init(self.shards)
        self.state_specs = {"params": param_specs, "opt": slot_specs}
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
        """The whole parameters from the shards (each sharded dim gathered
        over its axes)."""
        for n, p in self.params.items():
            dims = self._dims[n]
            if not dims:
                continue
            t = self.shards[n]
            for d, e in reversed(dims):
                t = _c._gather_raw(t, d, self.mesh.group(e))
            p.copy_(t)

    def _reduce_grads(self, grads: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The sum over the batch axes of every gradient: one all-reduce
        of a flat bucket per dtype (none when the batch ran whole on every
        rank: the gradients are the same there)."""
        if self._batch_group is None or (self._rows()[1] > 1
                                         and not self._split_rows):
            return grads
        out = dict(grads)
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for n, g in grads.items():
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

    def _step(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        gen = self.generator
        amp = _amp.auto_cast(enable=True, dtype=self.amp_dtype) \
            if self.amp_dtype is not None else contextlib.nullcontext()
        scaler = self.scaler
        before = [(b, b.clone()) for b in self.model.buffers()] \
            if scaler is not None or self._skip_guard else []
        first = args[0] if args else None
        local_rows = first.shape[0] if self._split_rows else None
        bn = _norm.global_batch(self._batch_group) \
            if self._split_rows else contextlib.nullcontext()
        with amp, _random.rng_scope(default=gen, dropout=gen):
            with bn:
                out = self.model(*args, **kwargs)
            out = self._gather_outputs(out, local_rows)
            loss = self.loss_fn(out, *labels)
        if scaler is not None:
            loss = scaler.scale(loss, self.scaler_state)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        grads = self._reduce_grads(grads)
        loss = loss.detach()
        if self._faults_armed:
            loss, grads = apply_fault_mults(loss, grads, self._grad_mult,
                                            self._loss_mult)
        found_inf = None
        if scaler is not None:
            grads, found_inf = scaler.unscale(grads, self.scaler_state)
            loss = loss / self.scaler_state["scale"].to(loss.dtype)
        elif self._skip_guard:
            found_inf = ~_amp.all_finite(grads)
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
        """The optimizer on the shards (see the module note), then the
        whole parameters gathered from them."""
        opt = self.optimizer
        if not any(self._dims.values()):
            with _random.rng_scope(default=gen):
                opt.apply_gradients(self.params, grads, self.state, ok,
                                    lr_override=lr)
            return
        if opt.grad_clip is not None:
            # the clip's norm is over the whole gradients; the
            # optimizer's own clip of the blocks then scales by 1 up to
            # rounding (no block exceeds what the whole was clipped to)
            from ..optimizer import _as_f32
            grads = {n: _as_f32(g) for n, g in grads.items()}
            meta = opt._param_meta
            sub = {n: g for n, g in grads.items()
                   if meta.get(n, (True, None))[0]}
            if sub:
                grads.update(opt.grad_clip(sub))
        shard_grads = {n: _block(g, self._dims[n], self.mesh).contiguous()
                       if self._dims[n] else g for n, g in grads.items()}
        with _random.rng_scope(default=gen):
            opt.apply_gradients(self.shards, shard_grads, self.state, ok,
                                lr_override=lr)
        self._gather_params()

    # -- the model and the state --------------------------------------------

    @torch.no_grad()
    def reset_from_model(self) -> None:
        """Re-reads the model's parameters into the shards (the JAX
        ``reset_from_model`` re-shards the eager model's weights)."""
        super().reset_from_model()
        for n, p in self.params.items():
            if self._dims[n]:
                self.shards[n].copy_(_block(p.detach(), self._dims[n],
                                            self.mesh))
            else:
                self.shards[n] = p
