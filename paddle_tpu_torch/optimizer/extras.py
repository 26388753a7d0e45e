"""Optimizer wrappers: ExponentialMovingAverage, ModelAverage, Lookahead
and GradientMerge.

Counterpart of ``paddle_tpu.optimizer.extras``. Each wraps an inner
optimizer (``wrapper.inner``) and keeps its own state under ``"wrap"``
in the optimizer state (``TrainStep.state["wrap"]``, checkpointed as
``opt/wrap/...``): the EMA shadow (``ema``), the window's running sum
and count (``sum``, ``count``), Lookahead's slow weights (``slow``),
GradientMerge's gradient accumulator and micro-step count (``acc``,
``micro``), each parameter-keyed tree in its parameter's dtype, as in
JAX. The inner update runs first, in place; then the wrapper's, in
place too. Every choice that depends on the step (EMA's warm-up decay,
the window restart, Lookahead's sync every ``k``, GradientMerge's
update every ``k_steps``) is a device select on the device step
counter, so a captured step records one graph for all steps. The skip
guard's ``ok`` leaves the wrapper's state and the parameters as they
were, as the JAX step discards the whole optimizer state;
GradientMerge hands its inner update ``ok & do_update``.

``apply(train_step)`` (EMA, ModelAverage) is a context that copies the
shadow or averaged weights into the step's parameters and the trained
ones back on exit, in place (the parameters keep their storage, so a
captured graph stays valid). Like the JAX wrappers they touch the
parameters, not the fp32 masters of low-precision ones. EMA's update is
computed in fp32 and stored in the shadow's dtype (JAX's own shadow of
a bf16 parameter turns fp32 after its first warm-up step).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

from . import Optimizer, _select

__all__ = ["ExponentialMovingAverage", "ModelAverage", "Lookahead",
           "GradientMerge"]


def _wrap_of(state) -> dict:
    """The wrapper state of an optimizer state (``TrainStep.state``) or of
    a whole training state (``TrainStep.state_dict()``)."""
    if "wrap" in state:
        return state["wrap"]
    return state["opt"]["wrap"]


def _copies(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in params.items()}


@contextlib.contextmanager
def _swapped(params: Dict[str, torch.Tensor],
             values: Dict[str, torch.Tensor]) -> Iterator[None]:
    """``values`` copied into ``params`` (in place) for the code inside;
    the old values back after."""
    saved = {n: p.detach().clone() for n, p in params.items()
             if n in values}
    with torch.no_grad():
        for n in saved:
            params[n].copy_(values[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, v in saved.items():
                params[n].copy_(v)


class _WrappedOptimizer(Optimizer):
    """Delegates to ``inner`` (its rate, parameter metadata and update)
    and adds the wrapper's state under ``state["wrap"]``."""

    def __init__(self, inner: Optimizer) -> None:
        self.inner = inner
        super().__init__(learning_rate=inner.learning_rate)

    @property
    def learning_rate(self):
        return self.inner.learning_rate

    @learning_rate.setter
    def learning_rate(self, value) -> None:
        self.inner.learning_rate = value

    def set_param_meta(self, meta) -> None:
        self.inner.set_param_meta(meta)

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state = self.inner.init(params)
        state["wrap"] = self.wrap_init(params)
        return state

    def wrap_init(self, params) -> dict:
        return {}

    @staticmethod
    def _inner_state(state: dict) -> dict:
        return {k: v for k, v in state.items() if k != "wrap"}

    @torch.no_grad()
    def apply_gradients(self, params, grads, state, ok=None,
                        lr_override=None) -> None:
        self.inner.apply_gradients(params, grads, self._inner_state(state),
                                   ok, lr_override)
        # the inner update advanced the counter in place (unless skipped,
        # when the wrapper's own writes are discarded too)
        self.wrap_update(params, state["wrap"], state["step"], ok)

    def wrap_update(self, params, wrap, step, ok) -> None:
        pass


class ExponentialMovingAverage(_WrappedOptimizer):
    """An EMA shadow of the parameters: ``ema = d ema + (1 - d) p`` after
    each update, ``d = min(decay, (1 + t) / (10 + t))`` with
    ``thres_steps`` (``t`` the step counter), else ``decay``."""

    def __init__(self, inner: Optimizer, decay: float = 0.999,
                 thres_steps: bool = True) -> None:
        super().__init__(inner)
        self.decay = decay
        self.thres_steps = thres_steps

    def wrap_init(self, params):
        return {"ema": _copies(params)}

    def wrap_update(self, params, wrap, step, ok) -> None:
        d = torch.clamp((1.0 + step) / (10.0 + step), max=self.decay) \
            if self.thres_steps else self.decay
        for n, e in wrap["ema"].items():
            new = d * e.float() + (1.0 - d) * params[n].float()
            e.copy_(_select(ok, new.to(e.dtype), e))

    @staticmethod
    def shadow_params(state) -> Dict[str, torch.Tensor]:
        return _wrap_of(state)["ema"]

    def apply(self, train_step):
        """A context with the EMA weights in ``train_step``'s parameters
        (ref: ``ema.apply()``)."""
        return _swapped(train_step.params,
                        self.shadow_params(train_step.state))


class ModelAverage(_WrappedOptimizer):
    """The running average of the parameters over a window of at most
    ``max_average_window`` updates: a running sum and count, restarted
    from the current parameters when the count reaches the window."""

    def __init__(self, inner: Optimizer, average_window_rate: float = 0.15,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000) -> None:
        super().__init__(inner)
        self.max_window = int(max_average_window)

    def wrap_init(self, params):
        dev = next(iter(params.values())).device
        return {"sum": {n: torch.zeros_like(p) for n, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def wrap_update(self, params, wrap, step, ok) -> None:
        count = wrap["count"]
        restart = count >= self.max_window
        for n, acc in wrap["sum"].items():
            p = params[n]
            acc.copy_(_select(ok, torch.where(restart, p, acc + p), acc))
        new_count = torch.where(restart, 0, count) + 1
        count.copy_(_select(ok, new_count.to(count.dtype), count))

    @staticmethod
    def averaged_params(state) -> Dict[str, torch.Tensor]:
        wrap = _wrap_of(state)
        c = torch.clamp(wrap["count"], min=1).to(torch.float32)
        return {n: s.float() / c for n, s in wrap["sum"].items()}

    def apply(self, train_step):
        """A context with the averaged weights (cast to each parameter's
        dtype) in ``train_step``'s parameters."""
        return _swapped(train_step.params,
                        self.averaged_params(train_step.state))


class Lookahead(_WrappedOptimizer):
    """Lookahead: the inner (fast) update every step; every ``k`` steps
    the slow weights move ``alpha`` of the way to the fast ones and the
    fast ones reset to them."""

    def __init__(self, inner: Optimizer, alpha: float = 0.5,
                 k: int = 5) -> None:
        super().__init__(inner)
        self.alpha = float(alpha)
        self.k = int(k)

    def wrap_init(self, params):
        return {"slow": _copies(params)}

    def wrap_update(self, params, wrap, step, ok) -> None:
        sync = torch.remainder(step, self.k) == 0
        for n, s in wrap["slow"].items():
            f = params[n]
            slow = torch.where(sync, s + self.alpha * (f - s), s)
            fast = torch.where(sync, slow, f)
            f.copy_(_select(ok, fast, f))
            s.copy_(_select(ok, slow, s))


class GradientMerge(_WrappedOptimizer):
    """``k_steps`` micro-steps' gradients summed (averaged with ``avg``)
    into one inner update on the last of them; the accumulator and the
    micro-step count live in the state, so every micro-step is the same
    captured graph."""

    def __init__(self, inner: Optimizer, k_steps: int = 1,
                 avg: bool = True) -> None:
        super().__init__(inner)
        self.k_steps = int(k_steps)
        self.avg = avg

    def wrap_init(self, params):
        dev = next(iter(params.values())).device
        return {"acc": {n: torch.zeros_like(p) for n, p in params.items()},
                "micro": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def apply_gradients(self, params, grads, state, ok=None,
                        lr_override=None) -> None:
        wrap = state["wrap"]
        acc = {n: wrap["acc"][n] + g for n, g in grads.items()
               if g is not None and n in wrap["acc"]}
        micro = wrap["micro"] + 1
        do_update = micro >= self.k_steps
        scale = 1.0 / self.k_steps if self.avg else 1.0
        inner_ok = do_update if ok is None else ok & do_update
        self.inner.apply_gradients(
            params, {n: a * scale for n, a in acc.items()},
            self._inner_state(state), inner_ok, lr_override)
        for n, a in acc.items():
            old = wrap["acc"][n]
            old.copy_(_select(ok, torch.where(do_update,
                                              torch.zeros_like(a), a), old))
        new_micro = torch.where(do_update, 0, micro).to(torch.int32)
        wrap["micro"].copy_(_select(ok, new_micro, wrap["micro"]))
