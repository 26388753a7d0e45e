"""DGC: deep gradient compression, a top-k sparsified gradient exchange.

Counterpart of ``paddle_tpu.parallel.dgc`` (``topk_sparsify``,
``dgc_allreduce``, ``dgc_momentum_exchange``, ``DGCTrainStep``). Each
replica (a rank of the ``dp`` axis) keeps only the top-k largest-magnitude
entries of what it would send, carries the rest forward locally, and the
replicas exchange just those entries: an all-gather of (values, indices)
over ``dp``, then a dense rebuild by scatter-add. The rules of the JAX
file's header, kept here:

- **momentum correction**: each replica accumulates a local velocity
  ``u = m*u + g`` and sparsifies ``residual + u``, so the exchanged
  entries carry momentum-accumulated mass;
- **momentum factor masking**: entries that were sent are zeroed in the
  velocity too;
- the outer optimizer's own momentum is set to zero while it updates
  (the JAX ``_with_zeroed_attr``), because the velocity already carries
  it;
- **dense warm-up**: the first ``rampup_steps`` steps exchange the whole
  ``residual + u`` densely (a mean over ``dp``: exactly momentum SGD).

The warm-up is chosen on the device from the step counter
(``torch.where`` over both exchanges, as the JAX step does), so every step
runs the same collectives and a captured step replays for the whole run.
Entries tied in magnitude are taken lower index first, as XLA's
``top_k`` takes them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..optimizer import Optimizer
from ..static import TrainStep
from . import collective as _c
from . import env as _env
from .localsgd import replica_batch
from .mesh import Mesh

__all__ = ["topk_sparsify", "dgc_allreduce", "dgc_momentum_exchange",
           "DGCTrainStep"]


def topk_sparsify(g: torch.Tensor, k: int):
    """Keeps the k largest-|g| entries: ``(values [k], indices [k],
    residual)``, the residual being ``g`` without the kept entries.
    Entries of equal magnitude are taken lower index first, as XLA's
    ``top_k`` takes them (a stable sort; a gradient pair such as a
    two-class head's, equal and opposite, ties exactly)."""
    flat = g.reshape(-1)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    vals = flat[idx]
    residual = flat.index_fill(0, idx, 0.0).reshape(g.shape)
    return vals, idx, residual


def _pg(axis):
    return None if axis is None else _c.resolve(axis)


def _exchange(vals: torch.Tensor, idx: torch.Tensor, size: int, pg,
              dtype) -> torch.Tensor:
    """The mean over the replicas of their sparse entries, dense: every
    replica's (values, indices) all-gathered, then scatter-added."""
    n = _c._size(pg)
    if pg is not None:
        _c._account("all_gather", [vals, idx])
        vals = _c._gather_raw(vals, 0, pg)
        idx = _c._gather_raw(idx, 0, pg)
    dense = torch.zeros(size, dtype=dtype, device=vals.device)
    return dense.index_add_(0, idx, vals) / n


def dgc_allreduce(local_grad: torch.Tensor, residual: torch.Tensor,
                  axis="dp", sparsity: float = 0.99):
    """One gradient compressed, exchanged and rebuilt over ``axis``:
    ``(the dense mean gradient, the new residual)``; ``residual`` is the
    error feedback carried from earlier steps."""
    pg = _pg(axis)
    acc = local_grad + residual
    k = max(1, int(acc.numel() * (1.0 - sparsity)))
    vals, idx, new_residual = topk_sparsify(acc, k)
    dense = _exchange(vals, idx, acc.numel(), pg, acc.dtype)
    return dense.reshape(acc.shape), new_residual


def dgc_momentum_exchange(grad: torch.Tensor, velocity: torch.Tensor,
                          residual: torch.Tensor, use_dgc, axis,
                          sparsity: float, momentum: float):
    """One leaf of the momentum-corrected step: ``(the delivered dense
    update, the new velocity, the new residual)``. ``use_dgc`` (a bool
    tensor) False is the warm-up: the mean of ``residual + u`` over the
    replicas, the velocity carried on whole and the residual emptied."""
    pg = _pg(axis)
    u = momentum * velocity + grad
    acc = residual + u
    k = max(1, int(acc.numel() * (1.0 - sparsity)))
    vals, idx, sparse_residual = topk_sparsify(acc, k)
    sparse_velocity = u.reshape(-1).index_fill(0, idx, 0.0).reshape(u.shape)
    sparse_update = _exchange(vals, idx, acc.numel(), pg,
                              acc.dtype).reshape(acc.shape)
    dense_update = acc if pg is None else _c._all_reduce_raw(acc, "mean",
                                                             pg)
    update = torch.where(use_dgc, sparse_update, dense_update)
    new_velocity = torch.where(use_dgc, sparse_velocity, u)
    new_residual = torch.where(use_dgc, sparse_residual,
                               torch.zeros_like(residual))
    return update, new_velocity, new_residual


class DGCTrainStep(TrainStep):
    """Data-parallel step whose gradient exchange is DGC-compressed.

    Every rank is called with the global batch and computes the gradient
    of its rows; each leaf is momentum-corrected, compressed, exchanged
    (:func:`dgc_momentum_exchange`) and handed to the optimizer, the same
    on every rank, so the parameters stay replicated. ``momentum`` is the
    optimizer's (Momentum, LarsMomentum), 0 for one without it; the
    optimizer runs with its own momentum set to 0. The reported loss is
    the mean of the replicas'. ``velocity``, ``residual`` and
    ``step_count`` are device state beside the optimizer's."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 loss_fn: Callable, mesh: Mesh, sparsity: float = 0.99,
                 rampup_steps: int = 3, seed: int = 0,
                 dp_axis: str = "dp") -> None:
        self.mesh = mesh
        self.sparsity = float(sparsity)
        self.rampup_steps = int(rampup_steps)
        self.axis = dp_axis
        self.momentum = float(getattr(optimizer, "momentum", 0.0))
        self.n_replicas = mesh.shape[dp_axis]
        self.replica = mesh.axis_index(dp_axis) \
            if mesh.coordinate is not None else 0
        self._pg = mesh.group(dp_axis)
        gloo = _env.is_initialized() and _env.backend() == "gloo"
        super().__init__(model, optimizer, loss_fn, seed=seed,
                         compiled=False if gloo else None)
        self._span_name = f"DGCTrainStep({type(model).__name__})"
        self.velocity = {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in self.params.items()}
        self.residual = {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in self.params.items()}
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)

    def _update(self, grads, ok, lr, gen) -> None:
        """The exchanged updates (see the module note) to the optimizer,
        its own momentum set to 0 while it runs."""
        use_dgc = self.step_count >= self.rampup_steps
        new = {}
        for n, g in grads.items():
            upd, vel, res = dgc_momentum_exchange(
                g.float(), self.velocity[n], self.residual[n], use_dgc,
                self._pg, self.sparsity, self.momentum)
            self.velocity[n].copy_(vel)
            self.residual[n].copy_(res)
            new[n] = upd
        self.step_count.add_(1)
        opt = self.optimizer
        saved = getattr(opt, "momentum", None)
        if self.momentum:
            opt.momentum = 0.0
        try:
            super()._update(new, ok, lr, gen)
        finally:
            if self.momentum:
                opt.momentum = saved

    def _step(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        metrics = super()._step(args, labels, kwargs, lr)
        if self._pg is not None:
            metrics["loss"] = _c._all_reduce_raw(metrics["loss"], "mean",
                                                 self._pg)
        return metrics

    def __call__(self, *args, labels=(), **kwargs):
        args, labels, kwargs = replica_batch(self, args, labels, kwargs)
        with self.mesh:
            return super().__call__(*args, labels=labels, **kwargs)
