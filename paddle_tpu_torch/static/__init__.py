"""TrainStep: one optimizer step of a model, a loss and an optimizer.

Counterpart of ``paddle_tpu.static.TrainStep``. The JAX class compiles
forward, backward and the update into one donated-state XLA program;
here the same step runs eagerly: the model's forward and the loss under
a per-step dropout stream (``core.random.step_generator(seed, call)``),
``torch.autograd.grad`` over the trainable parameters (a parameter the
loss does not reach gets a zero gradient, as JAX gives it), and the
optimizer's in-place update of the model's own parameters.

The skip-step guard (``skip_nonfinite_steps``, read at construction):
when any gradient is NaN/Inf the whole update is discarded, parameters,
optimizer moments and the step counter alike, selected on the device
(no host sync); ``nonfinite_steps`` counts such steps on the device.

Not ported yet: extra metrics, amp autocast and the GradScaler,
multi-step dispatch, the observability probes and fault multipliers.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..core import random as _random
from ..flags import GLOBAL_FLAGS
from ..optimizer import Adam

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, opt, loss_fn)``; ``step(*args,
    labels=(...), **kwargs)`` runs ``loss_fn(model(*args, **kwargs),
    *labels)``, updates the model in place and returns
    ``{"loss": loss}`` (a 0-d device tensor, not synchronised)."""

    def __init__(self, model: nn.Module, optimizer: Adam,
                 loss_fn: Callable, seed: int = 0) -> None:
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.seed = int(seed)
        self.params: Dict[str, torch.Tensor] = {
            n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self.params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        self.device = next(iter(self.params.values())).device
        self.state = optimizer.init(self.params)
        self._skip_guard = bool(GLOBAL_FLAGS.get("skip_nonfinite_steps"))
        self.calls = 0
        self.nonfinite_steps = torch.zeros((), dtype=torch.int64,
                                           device=self.device)

    def __call__(self, *args, labels=(), **kwargs) -> Dict[str,
                                                           torch.Tensor]:
        labels = tuple(labels) if isinstance(labels, (tuple, list)) \
            else (labels,)
        gen = _random.step_generator(self.seed, self.calls, self.device)
        self.calls += 1
        with _random.rng_scope(default=gen, dropout=gen):
            out = self.model(*args, **kwargs)
            loss = self.loss_fn(out, *labels)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as JAX
        # differentiates every parameter: AdamW still decays it and its
        # moments, and the skip guard and the fused routes cover it
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        ok = None
        if self._skip_guard:
            ok = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
            self.nonfinite_steps += (~ok).to(torch.int64)
        self.optimizer.apply_gradients(self.params, grads, self.state, ok)
        return {"loss": loss.detach()}
