"""LocalSGD: each replica takes k local steps, then the replicas average.

Counterpart of ``paddle_tpu.parallel.localsgd.LocalSGDStep``. The JAX step
stacks every replica's parameters on a leading axis sharded over ``dp``
and runs the local steps under ``shard_map`` with no cross-replica
collective, then every k-th call averages the parameters and the
optimizer's slots over ``dp`` (``pmean``). Here each rank of the ``dp``
axis is one replica and holds its own model, optimizer state and
buffers:

- every rank is called with the GLOBAL batch and trains on its rows (a
  kwarg whose leading dim is the batch size is split the same way, the
  others are replicated, as ``split_kwargs_by_shardable`` classifies
  them); no gradient crosses ranks;
- the reported loss is the mean of the replicas' losses (an all-reduce
  of the scalar);
- after every ``k_steps``-th call the parameters and every optimizer
  slot with a dim (moments, fp32 masters) are averaged over ``dp`` in
  place; the step counter and the buffers stay per replica, as in the
  JAX state.

A replica's step is ``static.TrainStep`` on its rows (eager under Gloo,
captured under NCCL; the averaging runs eagerly between steps and writes
in place, so a captured step's graph stays valid). Each replica draws
its dropout from ``seed + its index``. ``optimizer_fused_state`` is
refused, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from ..optimizer import Optimizer
from ..static import TrainStep
from . import collective as _c
from . import env as _env
from .mesh import Mesh
from .spmd import leading_batch_size, split_kwargs_by_shardable

__all__ = ["LocalSGDStep"]


def _rows(x, index: int, count: int):
    """This replica's rows of a batch leaf (the leaf itself when it does
    not split)."""
    if not isinstance(x, torch.Tensor) or x.ndim == 0 \
            or x.shape[0] % count:
        return x
    rows = x.shape[0] // count
    return x.narrow(0, index * rows, rows)


def replica_batch(step, args, labels, kwargs):
    """``(args, labels, kwargs)`` of the global batch cut to ``step``'s
    replica (its ``replica`` of ``n_replicas``) on its device: a kwarg
    whose leading dim is the batch size is split with the args and
    labels, the others (masks, tables, scalars) are replicated."""
    n, me = step.n_replicas, step.replica
    sh, rep = split_kwargs_by_shardable(
        kwargs, leading_batch_size(args, labels), note=n > 1)

    def cut(x):
        return _rows(torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(step.device), me, n)

    labels = labels if isinstance(labels, (tuple, list)) else (labels,)
    kwargs = {k: cut(v) for k, v in sh.items()}
    kwargs.update(rep)
    return (tuple(cut(a) for a in args), tuple(cut(y) for y in labels),
            kwargs)


class LocalSGDStep(TrainStep):
    """``step(*args, labels=(...), **kwargs)`` with the global batch on
    every rank: one local step of this replica on its rows (see the
    module note); returns ``{"loss": <mean over the replicas>}``."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, mesh: Mesh, k_steps: int = 4,
                 seed: int = 0, dp_axis: str = "dp") -> None:
        if optimizer._use_fused():
            raise ValueError(
                "optimizer_fused_state is incompatible with LocalSGD's "
                "replica-stacked optimizer state; construct the "
                "optimizer with fused_state=False")
        self.mesh = mesh
        self.k_steps = max(1, int(k_steps))
        self.axis = dp_axis
        self.n_replicas = mesh.shape[dp_axis]
        self._calls = 0
        self._pg = mesh.group(dp_axis)
        self.replica = mesh.axis_index(dp_axis) \
            if mesh.coordinate is not None else 0
        gloo = _env.is_initialized() and _env.backend() == "gloo"
        super().__init__(model, optimizer, loss_fn, seed=seed + self.replica,
                         compiled=False if gloo else None)
        self._span_name = f"LocalSGDStep({type(model).__name__})"

    def _step(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        metrics = super()._step(args, labels, kwargs, lr)
        if self._pg is not None:
            metrics["loss"] = _c._all_reduce_raw(metrics["loss"], "mean",
                                                 self._pg)
        return metrics

    def __call__(self, *args, labels=(), **kwargs):
        args, labels, kwargs = replica_batch(self, args, labels, kwargs)
        metrics = super().__call__(*args, labels=labels, **kwargs)
        self._calls += 1
        if self._calls % self.k_steps == 0:
            self._sync()
        return metrics

    @torch.no_grad()
    def _sync(self) -> None:
        """The parameters and the optimizer's slots averaged over the
        replicas, in place."""
        if self._pg is None:
            return
        leaves = list(self.params.values())
        for slots in self.state["slots"].values():
            leaves += [t for t in slots.values() if t.ndim > 0]
        for t in leaves:
            t.copy_(_c._all_reduce_raw(t, "mean", self._pg))

    @torch.no_grad()
    def averaged_params(self) -> Dict[str, torch.Tensor]:
        """The replicas' mean parameters (what a sync would leave); every
        rank calls it."""
        if self._pg is None:
            return {n: p.detach().clone() for n, p in self.params.items()}
        return {n: _c._all_reduce_raw(p, "mean", self._pg)
                for n, p in self.params.items()}

    @torch.no_grad()
    def replica_divergence(self) -> float:
        """The largest |entry - replica 0's entry| over the parameters and
        the replicas (0 right after a sync); every rank calls it."""
        div = torch.zeros((), dtype=torch.float32, device=self.device)
        for p in self.params.values():
            ref = p if self._pg is None else _c.broadcast(p, 0, self._pg)
            div = torch.maximum(div, (p - ref).abs().max().float())
        if self._pg is not None:
            div = _c._all_reduce_raw(div, "max", self._pg)
        return float(div)
