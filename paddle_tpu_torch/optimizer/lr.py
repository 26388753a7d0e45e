"""Learning-rate schedulers.

Counterpart of ``paddle_tpu.optimizer.lr``. A scheduler is a function
``lr_at(step)`` of the optimizer's step counter, written in torch ops so
that with the device step counter it runs on the device: the optimizer
evaluates it inside the update and the host never reads the step, as the
JAX package traces it into the compiled step. The arithmetic is the JAX
package's, in fp32. The object wrapper keeps the stateful
``step()``/``get_lr()`` API (``get_lr`` evaluates at ``last_epoch`` on
the host).

``ReduceOnPlateau`` follows a metric and is ``host_driven``: its live
value lives on the host, and ``static.TrainStep`` writes it into a
persistent fp32 device tensor before each step and passes that tensor to
the optimizer as ``lr_override`` (the JAX step takes it as an fp32
argument), so a captured step reads the value of the moment. The
constant tables a scheduler needs on the device (``PiecewiseDecay``'s
boundaries and values, ``MultiStepDecay``'s milestones) are built at its
first call and kept.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch

__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "CosineAnnealingDecay", "LinearWarmup", "StepDecay",
           "MultiStepDecay", "LambdaDecay", "ReduceOnPlateau", "OneCycleLR",
           "resolve_lr"]

Step = Union[int, torch.Tensor]


def _step_tensor(step: Step) -> torch.Tensor:
    """The step as an int tensor (a Python int on the CPU)."""
    if isinstance(step, torch.Tensor):
        return step
    return torch.tensor(int(step), dtype=torch.int32)


def _f32(step: Step) -> torch.Tensor:
    return _step_tensor(step).to(torch.float32)


def _const(owner, name: str, values, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, built at the first call for
    that (name, dtype, device) and kept on ``owner``: a host-to-device
    copy inside the step would cost a copy per step, and a CUDA graph of
    the step cannot capture one."""
    cache = owner.__dict__.setdefault("_consts", {})
    key = (name, dtype, device)
    t = cache.get(key)
    if t is None:
        t = cache[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


class LRScheduler:
    """Base: subclasses implement ``lr_at(step)`` in torch ops.
    ``host_driven`` schedulers (metric-driven) are fed to the step as a
    host value instead (see the module note)."""

    host_driven = False

    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.step()  # advance to epoch 0 like the reference

    def lr_at(self, step: Step) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, step: Step) -> torch.Tensor:
        return self.lr_at(step)

    def get_lr(self) -> float:
        return float(self.lr_at(self.last_epoch))

    def step(self, epoch: Optional[int] = None) -> None:
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        if self.verbose:
            print(f"Epoch {self.last_epoch}: {type(self).__name__} set "
                  f"learning rate to {self.get_lr()}.")

    def state_dict(self) -> dict:
        return {"last_epoch": self.last_epoch}

    def set_state_dict(self, state: dict) -> None:
        self.last_epoch = state["last_epoch"]


class NoamDecay(LRScheduler):
    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        step = torch.clamp_min(_step_tensor(step), 1).to(torch.float32)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * torch.minimum(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch: int = -1, verbose: bool = False) -> None:
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def lr_at(self, step):
        step = _step_tensor(step)
        bounds = _const(self, "boundaries", self.boundaries, step.dtype,
                        step.device)
        idx = torch.searchsorted(bounds, step, right=True)
        return _const(self, "values", self.values, torch.float32,
                      step.device)[idx]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False) -> None:
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * torch.exp(-self.gamma * _f32(step))


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False) -> None:
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * torch.pow(self.gamma, _f32(step))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False) -> None:
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr / (1.0 + self.gamma * _f32(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0,
                 cycle: bool = False, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        step_f = _f32(step)
        if self.cycle:
            ratio = torch.ceil(torch.clamp_min(step_f, 1.0)
                               / self.decay_steps)
            ds = self.decay_steps * torch.clamp_min(ratio, 1.0)
        else:
            ds = float(self.decay_steps)
            step_f = torch.clamp_max(step_f, ds)
        frac = (1.0 - step_f / ds) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int,
                 eta_min: float = 0.0, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        cos = torch.cos(math.pi * _f32(step) / self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class LinearWarmup(LRScheduler):
    """A linear ramp from ``start_lr`` to ``end_lr`` over
    ``warmup_steps``, then ``learning_rate`` (a float, or a scheduler
    evaluated at ``step - warmup_steps``)."""

    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.lr_after = learning_rate
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        base = learning_rate if isinstance(learning_rate, float) \
            else learning_rate.base_lr
        super().__init__(base, last_epoch, verbose)

    def lr_at(self, step):
        step = _step_tensor(step)
        step_f = step.to(torch.float32)
        warm = self.start_lr + (self.end_lr - self.start_lr) \
            * step_f / max(self.warmup_steps, 1)
        if isinstance(self.lr_after, LRScheduler):
            after = self.lr_after.lr_at(step - self.warmup_steps)
        else:
            after = torch.full_like(warm, self.lr_after)
        return torch.where(step_f < self.warmup_steps, warm, after)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int,
                 gamma: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        k = torch.div(_step_tensor(step), self.step_size,
                      rounding_mode="floor").to(torch.float32)
        return self.base_lr * torch.pow(self.gamma, k)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones: Sequence[int],
                 gamma: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        step = _step_tensor(step)
        bounds = _const(self, "milestones", self.milestones, step.dtype,
                        step.device)
        idx = torch.searchsorted(bounds, step, right=True)
        return self.base_lr * torch.pow(self.gamma, idx.to(torch.float32))


class LambdaDecay(LRScheduler):
    """``learning_rate * lr_lambda(step)``; ``lr_lambda`` gets the step
    as a tensor and must compute in torch ops (``0.95 ** step`` does)."""

    def __init__(self, learning_rate: float, lr_lambda: Callable,
                 last_epoch: int = -1, verbose: bool = False) -> None:
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.lr_lambda(_step_tensor(step))


class ReduceOnPlateau(LRScheduler):
    """Metric-driven and host-side: call ``.step(metric)`` per epoch;
    the train step reads ``get_lr()`` (a host float, no device read)."""

    host_driven = True

    def __init__(self, learning_rate: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0, verbose: bool = False) -> None:
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.current_lr = learning_rate
        self.base_lr = learning_rate
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self) -> float:
        return float(self.current_lr)

    def lr_at(self, step):
        return torch.tensor(self.current_lr, dtype=torch.float32,
                            device=_step_tensor(step).device)

    def step(self, metrics=None, epoch: Optional[int] = None) -> None:
        if metrics is None:
            return
        m = float(metrics)
        improved = (self.best is None
                    or (self.mode == "min" and m < self.best - self.threshold)
                    or (self.mode == "max" and m > self.best + self.threshold))
        if improved:
            self.best = m
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.current_lr * self.factor,
                                      self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        self.last_epoch += 1


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate: float, total_steps: int,
                 divide_factor: float = 25.0, end_learning_rate=None,
                 phase_pct: float = 0.3, last_epoch: int = -1,
                 verbose: bool = False) -> None:
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.min_lr = end_learning_rate if end_learning_rate is not None \
            else self.initial_lr / 1e4
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def lr_at(self, step):
        step_f = _f32(step)
        up_steps = self.phase_pct * self.total_steps
        down_steps = self.total_steps - up_steps
        up = self.initial_lr + (self.max_lr - self.initial_lr) \
            * torch.clamp_max(step_f / max(up_steps, 1.0), 1.0)
        pct = torch.clamp((step_f - up_steps) / max(down_steps, 1.0),
                          0.0, 1.0)
        down = self.min_lr + (self.max_lr - self.min_lr) \
            * (1 + torch.cos(math.pi * pct)) / 2
        return torch.where(step_f < up_steps, up, down)


def resolve_lr(lr, step: Step):
    """The learning rate at ``step``: a scheduler's ``lr_at(step)`` (an
    fp32 tensor on the step's device), or a float as it is (a Python
    scalar costs no transfer; torch rounds it to fp32 where it meets an
    fp32 tensor, as the JAX package's ``jnp.asarray(lr, float32)``)."""
    if isinstance(lr, LRScheduler):
        return lr.lr_at(step)
    return float(lr)
