"""TrainStep and EvalStep: one optimizer step, and one evaluation, of a
model.

Counterpart of ``paddle_tpu.static.TrainStep`` and ``EvalStep``. The JAX
class compiles forward, backward and the update into one donated-state
XLA program; here the same step runs eagerly: the model's forward and
the loss under a per-step dropout stream
(``core.random.step_generator(seed, call)``), ``torch.autograd.grad``
over the trainable parameters (a parameter the loss does not reach gets
a zero gradient, as JAX gives it), and the optimizer's in-place update
of the model's own parameters.

- The skip-step guard (``skip_nonfinite_steps``, read at construction):
  when any gradient is NaN/Inf the whole update is discarded,
  parameters, fp32 masters, optimizer moments and the step counter
  alike, selected on the device (no host sync); ``nonfinite_steps``
  counts such steps on the device.
- ``amp_dtype`` runs the forward under ``amp.auto_cast`` (thread-local
  state only, as in the JAX package; the model's dtypes are its own:
  cast it with ``amp.cast_model_to_low_precision``). A ``GradScaler``
  scales the loss, unscales the gradients in their dtype and checks
  them, discards a non-finite step whatever the flag, and updates its
  state, all on the device (``scaler_state``).
- A host-driven scheduler (``ReduceOnPlateau``) reaches the optimizer as
  ``lr_override``, its live host value read at each call.
- ``extra_metrics`` ``{name: fn(outputs, *labels)}`` are computed on the
  step's own forward outputs, before the update.
- ``run_steps`` runs K stacked batches as K steps (see there).

Not ported: the observability probes, fault multipliers and the
divergence-rollback LR scale; buffers the forward updates are not
guarded (the ported models have none).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .. import amp as _amp
from ..core import random as _random
from ..flags import GLOBAL_FLAGS
from ..optimizer import Optimizer

__all__ = ["TrainStep", "EvalStep"]


def _labels(labels) -> tuple:
    return tuple(labels) if isinstance(labels, (tuple, list)) \
        else (labels,)


def _host_lr(optimizer) -> Optional[float]:
    """The live value of a host-driven scheduler (a host float, no
    device read), else None."""
    sched = getattr(optimizer, "learning_rate", None)
    if getattr(sched, "host_driven", False):
        return float(sched.get_lr())
    return None


def _wire_param_meta(model: nn.Module, optimizer: Optimizer) -> None:
    """Hand each parameter's ``need_clip`` / ``regularizer`` attributes
    (where set) to the optimizer, keyed by parameter name."""
    meta = {}
    for n, p in model.named_parameters():
        need_clip = getattr(p, "need_clip", True)
        reg = getattr(p, "regularizer", None)
        if not need_clip or reg is not None:
            meta[n] = (need_clip, reg)
    if meta:
        optimizer.set_param_meta(meta)


def _index(tree, i: int):
    """Entry ``i`` of the leading axis of every tensor in ``tree``."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class TrainStep:
    """``step = TrainStep(model, opt, loss_fn)``; ``step(*args,
    labels=(...), **kwargs)`` runs ``loss_fn(model(*args, **kwargs),
    *labels)``, updates the model in place and returns ``{"loss": loss,
    <extra metrics>}`` (0-d device tensors, not synchronised)."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 loss_fn: Callable,
                 extra_metrics: Optional[Dict[str, Callable]] = None,
                 seed: int = 0, amp_dtype=None, scaler=None) -> None:
        self.model = model
        self.optimizer = optimizer
        _wire_param_meta(model, optimizer)
        self.loss_fn = loss_fn
        self.extra_metrics = dict(extra_metrics or {})
        self.seed = int(seed)
        self.amp_dtype = amp_dtype
        if scaler is not None and not scaler.enable:
            scaler = None
        self.scaler = scaler
        self.params: Dict[str, torch.Tensor] = {
            n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self.params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        self.device = next(iter(self.params.values())).device
        self.state = optimizer.init(self.params)
        self.scaler_state = None if scaler is None \
            else scaler.init(self.device)
        self._skip_guard = bool(GLOBAL_FLAGS.get("skip_nonfinite_steps"))
        self.calls = 0
        self.nonfinite_steps = torch.zeros((), dtype=torch.int64,
                                           device=self.device)

    def _step(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        gen = _random.step_generator(self.seed, self.calls, self.device)
        self.calls += 1
        amp = _amp.auto_cast(enable=True, dtype=self.amp_dtype) \
            if self.amp_dtype is not None else contextlib.nullcontext()
        with amp, _random.rng_scope(default=gen, dropout=gen):
            out = self.model(*args, **kwargs)
            loss = self.loss_fn(out, *labels)
        scaler = self.scaler
        if scaler is not None:
            loss = scaler.scale(loss, self.scaler_state)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as JAX
        # differentiates every parameter: AdamW still decays it and its
        # moments, and the skip guard and the fused routes cover it
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        loss = loss.detach()
        found_inf = None
        if scaler is not None:
            grads, found_inf = scaler.unscale(grads, self.scaler_state)
            loss = loss / self.scaler_state["scale"].to(loss.dtype)
        elif self._skip_guard:
            found_inf = ~_amp.all_finite(grads)
        metrics = {"loss": loss}
        if self.extra_metrics:
            # on this step's outputs, before the update rewrites the
            # parameters they may hold (MLMHeadOutput's tied weight)
            with torch.no_grad():
                for name, fn in self.extra_metrics.items():
                    metrics[name] = fn(out, *labels)
        ok = None
        if found_inf is not None:
            ok = ~found_inf
            self.nonfinite_steps += found_inf.to(torch.int64)
        self.optimizer.apply_gradients(self.params, grads, self.state, ok,
                                       lr_override=lr)
        if scaler is not None:
            self.scaler_state = scaler.update(self.scaler_state, found_inf)
        return metrics

    def __call__(self, *args, labels=(), **kwargs) -> Dict[str,
                                                           torch.Tensor]:
        return self._step(args, _labels(labels), kwargs,
                          _host_lr(self.optimizer))

    def run_steps(self, *args, labels=(), **kwargs) -> Dict[str,
                                                            torch.Tensor]:
        """K steps over K stacked batches: every tensor of ``args``,
        ``labels`` and ``kwargs`` carries a leading axis K. The steps draw
        the same dropout streams as K calls, a host-driven scheduler's
        live value is read once and held for the K steps, and the
        metrics come back stacked on a leading K axis
        (``metrics["loss"][-1]`` is the latest). Runs the K steps one by
        one (the JAX package's one compiled scan is its speed, not its
        function)."""
        labels = _labels(labels)
        first = _first_tensor((args, labels, kwargs))
        if first is None or first.ndim == 0:
            raise ValueError("run_steps needs batches stacked on a "
                             "leading steps axis")
        lr = _host_lr(self.optimizer)
        per = [self._step(_index(args, i), _index(labels, i),
                          _index(kwargs, i), lr)
               for i in range(first.shape[0])]
        return {k: torch.stack([m[k] for m in per]) for k in per[0]}

    def reset_from_model(self) -> None:
        """Re-read the model's trainable parameters (after parameters
        were replaced on the model). The optimizer state carries over, as
        in the JAX package, fp32 masters included: a bf16 parameter's
        next update starts from its master, so re-``init`` the state
        (``step.state = step.optimizer.init(step.params)``) to train on
        from weights loaded into a low-precision model."""
        self.params = {n: p for n, p in self.model.named_parameters()
                       if p.requires_grad}


class EvalStep:
    """Inference step: ``EvalStep(model, metric_fns)(params, buffers,
    *args, labels=())`` runs the model in eval mode without autograd and
    returns ``(outputs, {name: fn(outputs, *labels)})``. ``params`` /
    ``buffers`` (name -> tensor) replace the model's own for the call
    (``torch.func.functional_call``); None uses the model's. The model's
    training mode is restored after."""

    def __init__(self, model: nn.Module,
                 metric_fns: Optional[Dict[str, Callable]] = None) -> None:
        self.model = model
        self.metric_fns = dict(metric_fns or {})

    @torch.no_grad()
    def __call__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 buffers: Optional[Dict[str, torch.Tensor]] = None,
                 *args: Any, labels=()):
        labels = _labels(labels)
        was_training = self.model.training
        self.model.eval()
        try:
            if params is None and buffers is None:
                out = self.model(*args)
            else:
                out = torch.func.functional_call(
                    self.model, {**(params or {}), **(buffers or {})}, args)
        finally:
            if was_training:
                self.model.train()
        metrics = {name: fn(out, *labels)
                   for name, fn in self.metric_fns.items()}
        return out, metrics
