"""Strategy compiler: a ``DistributedStrategy`` to a composed train step.

Counterpart of ``paddle_tpu.distributed.fleet.strategy_compiler``
(``apply_strategy``, ``_ComposedTrainStep``), with the JAX routing:

- ``dgc`` -> ``parallel.DGCTrainStep``, ``localsgd`` ->
  ``parallel.LocalSGDStep`` (they replace the step; neither composes
  with ``amp``, which raises, as in the JAX package);
- ``lamb`` / ``lars`` -> the optimizer replaced by ``Lamb`` /
  ``LarsMomentum``;
- everything else -> :class:`_ComposedTrainStep`, a
  ``parallel.ShardedTrainStep`` with ``tensor_parallel`` (the Megatron
  rule over ``mp``, partitioned for real), ``sharding`` (the ZeRO stage),
  ``amp`` (the amp dtype; fp16 adds a ``GradScaler``, static when
  ``use_dynamic_loss_scaling`` is off), ``recompute`` (the model's
  forward recomputed in the backward) and ``gradient_merge``
  (``grad_accum_steps`` microbatches of the global batch, their gradients
  summed, and averaged with ``avg``).

Without a mesh: ``tensor_parallel`` makes ``{"dp": -1, "mp": degree}``,
otherwise the data-parallel mesh over every rank. ``hierarchical_
allreduce`` builds the JAX multislice mesh (``{"dcn": hosts}`` x ``{"dp":
-1}``) and splits the batch over ``("dcn", "dp")``: on the ranks of one
host (``LOCAL_WORLD_SIZE`` = the world) ``dcn`` has size 1 and the
reduction is the data-parallel one; with DGC or LocalSGD it is the flat
``dp`` mesh, as in the JAX package. The JAX ``recompute_configs.policy``
names a ``jax.checkpoint`` policy; here every policy recomputes the whole
forward (``remat_policy`` keeps the name).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...core import random as _random
from ...optimizer import Lamb, LarsMomentum, Momentum, Optimizer
from ...parallel.mesh import (P, create_mesh, create_multislice_mesh,
                              data_parallel_mesh, multislice_data_spec,
                              num_slices)
from ...parallel.spmd import (ShardedTrainStep, leading_batch_size,
                              megatron_param_rule)

__all__ = ["apply_strategy"]


def apply_strategy(strategy, model: nn.Module, optimizer: Optimizer,
                   loss_fn: Callable, mesh=None, seed: int = 0,
                   param_rule=None, batch_spec: P = P("dp")):
    """The train step ``strategy`` composes (see the module note)."""
    if mesh is None:
        tp = strategy.tensor_parallel_configs.get(
            "tensor_parallel_degree", 1) if strategy.tensor_parallel else 1
        if strategy.hierarchical_allreduce and (strategy.dgc
                                                or strategy.localsgd):
            mesh = data_parallel_mesh()
        elif strategy.hierarchical_allreduce:
            slices = max(num_slices(), 1)
            ici = {"dp": -1, "mp": tp} if tp > 1 else {"dp": -1}
            mesh = create_multislice_mesh({"dcn": slices}, ici)
            if tuple(batch_spec) == ("dp",):
                batch_spec = multislice_data_spec(mesh)
        elif strategy.tensor_parallel:
            mesh = create_mesh({"dp": -1, "mp": tp})
        else:
            mesh = data_parallel_mesh()

    if strategy.amp and (strategy.dgc or strategy.localsgd):
        raise ValueError(
            "strategy.amp does not compose with dgc/localsgd yet — "
            "those steps bypass the AMP pipeline, so enabling both "
            "would silently train in full precision. Disable one.")
    if strategy.dgc:
        from ...parallel.dgc import DGCTrainStep
        return DGCTrainStep(
            model, optimizer, loss_fn, mesh,
            sparsity=strategy.dgc_configs.sparsity,
            rampup_steps=strategy.dgc_configs.rampup_begin_step, seed=seed)
    if strategy.localsgd:
        from ...parallel.localsgd import LocalSGDStep
        return LocalSGDStep(
            model, optimizer, loss_fn, mesh,
            k_steps=strategy.localsgd_configs.k_steps, seed=seed)

    if strategy.lamb and not isinstance(optimizer, Lamb):
        optimizer = Lamb(learning_rate=optimizer.learning_rate)
    if strategy.lars and isinstance(optimizer, Momentum) and \
            not isinstance(optimizer, LarsMomentum):
        optimizer = LarsMomentum(learning_rate=optimizer.learning_rate,
                                 momentum=optimizer.momentum)

    if strategy.tensor_parallel and param_rule is None:
        param_rule = megatron_param_rule("mp")

    remat_policy = strategy.recompute_configs.policy \
        if strategy.recompute else None
    k_steps = strategy.gradient_merge_configs.k_steps \
        if strategy.gradient_merge else 1

    amp_dtype = None
    scaler = None
    if strategy.amp:
        from ...amp import GradScaler
        from ...core.dtype import convert_dtype
        amp_dtype = strategy.amp_configs.dtype
        if convert_dtype(amp_dtype) == torch.float16:
            if strategy.amp_configs.use_dynamic_loss_scaling:
                scaler = GradScaler(
                    init_loss_scaling=strategy.amp_configs
                    .init_loss_scaling)
            else:
                scaler = GradScaler(
                    init_loss_scaling=strategy.amp_configs
                    .init_loss_scaling,
                    incr_ratio=1.0, decr_ratio=1.0)

    zero_stage = strategy.sharding_configs.stage if strategy.sharding else 0
    return _ComposedTrainStep(
        model, optimizer, loss_fn, mesh, batch_spec=batch_spec,
        param_rule=param_rule, seed=seed, remat_policy=remat_policy,
        grad_accum_steps=k_steps,
        grad_accum_avg=strategy.gradient_merge_configs.avg,
        zero_stage=zero_stage,
        amp_dtype=amp_dtype, scaler=scaler)


def _micro(x, i: int, k: int, rows: int):
    """Microbatch ``i`` of ``k`` of a leaf whose leading dim is ``rows``
    (any other leaf whole)."""
    if not isinstance(x, torch.Tensor) or x.ndim == 0 or x.shape[0] != rows:
        return x
    size = rows // k
    return x.narrow(0, i * size, size)


class _ComposedTrainStep(ShardedTrainStep):
    """``ShardedTrainStep`` with recompute and gradient merge composed
    (see the module note). The microbatches are the JAX step's: slices of
    the GLOBAL batch, each split over the batch axes; ``__call__`` orders
    the global rows of the inputs so that this rank's rows, cut into
    ``grad_accum_steps`` slices, are its rows of each microbatch (the
    labels stay global and are cut into the microbatches as they are)."""

    def __init__(self, model, optimizer, loss_fn, mesh, batch_spec=P("dp"),
                 param_rule=None, seed: int = 0, remat_policy=None,
                 grad_accum_steps: int = 1, grad_accum_avg: bool = True,
                 zero_stage: int = 0,
                 extra_metrics=None, amp_dtype=None, scaler=None) -> None:
        self.remat_policy = remat_policy
        self.grad_accum_steps = int(grad_accum_steps)
        self.grad_accum_avg = grad_accum_avg
        super().__init__(model, optimizer, loss_fn, mesh,
                         batch_spec=batch_spec, param_rule=param_rule,
                         seed=seed, extra_metrics=extra_metrics,
                         zero_stage=zero_stage, amp_dtype=amp_dtype,
                         scaler=scaler)

    def _call_model(self, args, kwargs):
        if self.remat_policy is None or not torch.is_grad_enabled():
            return super()._call_model(args, kwargs)
        tape = _random.DrawTape()
        names = list(kwargs)

        def run(*flat):
            with _random.replay_draws(tape):
                return self.model(*flat[:len(args)], **dict(
                    zip(names, flat[len(args):])))

        return checkpoint(run, *args, *(kwargs[n] for n in names),
                          use_reentrant=False, preserve_rng_state=False)

    def __call__(self, *args, labels=(), **kwargs):
        k = self.grad_accum_steps
        count = self._rows()[1]
        rows = leading_batch_size(args, labels if isinstance(
            labels, (tuple, list)) else (labels,))
        if k > 1 and count > 1 and rows and rows % (k * count) == 0:
            # global row order [rank][microbatch][row]: rank r's block is
            # its rows of microbatch 0, then of microbatch 1, ...
            per = rows // (k * count)
            order = torch.arange(rows).reshape(k, count, per)
            order = order.transpose(0, 1).reshape(-1)

            def perm(x):
                x = self._as_tensor(x)
                if not isinstance(x, torch.Tensor) or x.ndim == 0 \
                        or x.shape[0] != rows:
                    return x
                return x.index_select(0, order.to(x.device))

            # (the labels stay global, in their order: each microbatch's
            # outputs are gathered back into it)
            args = tuple(perm(a) for a in args)
            kwargs = {n: perm(v) for n, v in kwargs.items()}
        return super().__call__(*args, labels=labels, **kwargs)

    def _forward_grads(self, args, labels, kwargs):
        k = self.grad_accum_steps
        rows = leading_batch_size(args, labels)
        if k <= 1 or not rows or rows % k:
            return super()._forward_grads(args, labels, kwargs)
        total, grads, out = None, None, None
        for i in range(k):
            loss, g, out = super()._forward_grads(
                tuple(_micro(a, i, k, rows) for a in args),
                tuple(_micro(y, i, k, y.shape[0] if isinstance(
                    y, torch.Tensor) and y.ndim else 0) for y in labels),
                {n: _micro(v, i, k, rows) for n, v in kwargs.items()})
            total = loss if total is None else total + loss
            grads = g if grads is None else {n: grads[n] + g[n]
                                             for n in grads}
        if self.grad_accum_avg:
            grads = {n: v / k for n, v in grads.items()}
        return total / k, grads, out
