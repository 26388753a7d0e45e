"""Automatic mixed precision.

Counterpart of ``paddle_tpu.amp``. Mixed-precision training in the JAX
package is the O2 recipe: the whole model cast to bf16 (or fp16) with
``cast_model_to_low_precision``, fp32 master weights and moments kept by
the optimizer, and for fp16 a dynamic loss scale (:class:`GradScaler`)
whose scale, unscale, finiteness check and update run inside the train
step on device tensors, so the step never reads them on the host.

``auto_cast`` only records thread-local state (``amp_enabled``,
``amp_dtype``), read by ``low_precision_policy`` alone; no op of the
ported paths calls that. It is deliberately NOT ``torch.autocast``:
autocast would recast the model's matmuls and change what a
``TrainStep(amp_dtype=...)`` computes, which the JAX package leaves as
the model's own dtypes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Mapping, Tuple

import torch

from ..core.dtype import convert_dtype
from ..nn.layer import to_dtype

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard",
           "amp_enabled", "amp_dtype", "cast_model_to_low_precision",
           "low_precision_policy", "all_finite", "select_update",
           "GradScaler", "decorate"]

# ops that benefit from low precision (the matmul family)
WHITE_LIST = {"matmul", "mul", "conv2d", "conv3d", "bmm", "einsum", "linear"}
# ops that must stay fp32 (reductions, norms, softmax, exp)
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "batch_norm", "mean", "sum", "exp", "log"}


class _AmpState(threading.local):
    def __init__(self) -> None:
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"


_amp_state = _AmpState()


@contextlib.contextmanager
def auto_cast(enable: bool = True, dtype="bfloat16", level: str = "O1",
              custom_white_list=None,
              custom_black_list=None) -> Iterator[None]:
    """Record amp as on (or off) with ``dtype`` for the code inside; the
    previous state returns on exit. Nests."""
    prev = (_amp_state.enabled, _amp_state.dtype, _amp_state.level)
    _amp_state.enabled = enable
    _amp_state.dtype = convert_dtype(dtype)
    _amp_state.level = level
    try:
        yield
    finally:
        _amp_state.enabled, _amp_state.dtype, _amp_state.level = prev


amp_guard = auto_cast


def amp_enabled() -> bool:
    return _amp_state.enabled


def amp_dtype() -> torch.dtype:
    return _amp_state.dtype


def cast_model_to_low_precision(model: torch.nn.Module,
                                dtype="bfloat16") -> torch.nn.Module:
    """O2-style whole-model cast: every floating parameter to ``dtype``,
    buffers untouched (``nn.layer.to_dtype``)."""
    return to_dtype(model, dtype)


def low_precision_policy(x: torch.Tensor,
                         op_name: str = "matmul") -> torch.Tensor:
    """Cast an op's input by the white/black lists while amp is on."""
    if not _amp_state.enabled:
        return x
    if op_name in BLACK_LIST:
        return x.float() if x.dtype == _amp_state.dtype else x
    if op_name in WHITE_LIST and x.is_floating_point():
        return x.to(_amp_state.dtype)
    return x


def _floats(tree) -> list:
    """The floating tensors of a dict / list / tuple tree (integer
    leaves, such as step counters, are left out)."""
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _floats(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _floats(v)]
    return []


def all_finite(tree) -> torch.Tensor:
    """A 0-d bool device tensor: every floating tensor of ``tree`` is
    finite (True for a tree without one)."""
    leaves = _floats(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


def select_update(found_inf: torch.Tensor, updated, current):
    """``where(found_inf, current, updated)`` per tensor of two trees of
    the same structure (dicts, lists, tuples): the skip-step selection,
    on the device."""
    if isinstance(updated, torch.Tensor):
        return torch.where(found_inf, current, updated)
    if isinstance(updated, Mapping):
        return {k: select_update(found_inf, updated[k], current[k])
                for k in updated}
    if isinstance(updated, (list, tuple)):
        return type(updated)(select_update(found_inf, u, c)
                             for u, c in zip(updated, current))
    return updated


class GradScaler:
    """Dynamic loss scaling (Paddle's ``update_loss_scaling``): the scale
    grows by ``incr_ratio`` after ``incr_every_n_steps`` clean steps in a
    row and shrinks by ``decr_ratio`` (not below 1) after
    ``decr_every_n_nan_or_inf`` steps with a non-finite gradient.

    Functional, on device tensors::

        state = scaler.init(device)
        loss_s = scaler.scale(loss, state)
        grads, found_inf = scaler.unscale(grads, state)
        ... discard the update where found_inf ...
        scaler.update(state, found_inf)   # in place; returns state
    """

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2) -> None:
        self.enable = enable
        self.init_loss_scaling = init_loss_scaling
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n_nan_or_inf = decr_every_n_nan_or_inf

    def init(self, device="cpu") -> Dict[str, torch.Tensor]:
        return {"scale": torch.tensor(self.init_loss_scaling,
                                      dtype=torch.float32, device=device),
                "good_steps": torch.zeros((), dtype=torch.int32,
                                          device=device),
                "bad_steps": torch.zeros((), dtype=torch.int32,
                                         device=device)}

    def scale(self, loss: torch.Tensor, state) -> torch.Tensor:
        if not self.enable:
            return loss
        return loss * state["scale"].to(loss.dtype)

    def unscale(self, grads: Dict[str, Any],
                state) -> Tuple[Dict[str, Any], torch.Tensor]:
        """``(grads / scale, found_inf)``: each floating gradient times
        ``1 / scale`` in its own dtype, and whether any of them is not
        finite (a 0-d bool device tensor)."""
        if not self.enable:
            dev = state["scale"].device
            return grads, torch.zeros((), dtype=torch.bool, device=dev)
        inv = 1.0 / state["scale"]
        unscaled = {n: g * inv.to(g.dtype)
                    if isinstance(g, torch.Tensor) and g.is_floating_point()
                    else g for n, g in grads.items()}
        return unscaled, ~all_finite(unscaled)

    def update(self, state, found_inf: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """The state after a step whose gradients were non-finite where
        ``found_inf``: written in place (a CUDA graph of the step reads
        it where it was captured) and returned."""
        if not self.enable:
            return state
        zero = torch.zeros_like(state["good_steps"])
        good = torch.where(found_inf, zero, state["good_steps"] + 1)
        bad = torch.where(found_inf, state["bad_steps"] + 1, zero)
        scale = state["scale"]
        incr = good >= self.incr_every_n_steps
        scale = torch.where(incr, scale * self.incr_ratio, scale)
        good = torch.where(incr, zero, good)
        decr = bad >= self.decr_every_n_nan_or_inf
        scale = torch.where(decr, torch.clamp_min(scale * self.decr_ratio,
                                                  1.0), scale)
        bad = torch.where(decr, zero, bad)
        for name, val in (("scale", scale), ("good_steps", good),
                          ("bad_steps", bad)):
            state[name].copy_(val)
        return state


def decorate(optimizer, amp_lists=None,
             init_loss_scaling: float = 2.0 ** 15,
             use_dynamic_loss_scaling: bool = True
             ) -> Tuple[Any, GradScaler]:
    """Returns ``(optimizer, GradScaler)`` (the optimizer already keeps
    fp32 masters for low-precision parameters)."""
    scaler = GradScaler(enable=use_dynamic_loss_scaling,
                        init_loss_scaling=init_loss_scaling)
    return optimizer, scaler
