"""Optimizers: Adam and AdamW as Paddle computes them.

Counterpart of ``paddle_tpu.optimizer`` (``Adam``, ``AdamW``). Paddle's
Adam is not ``torch.optim.Adam``: ``eps`` is added to the UNCORRECTED
``sqrt(v)``, and the bias correction is folded into the learning rate,

    m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2,
    lr_c = lr sqrt(1 - b2^t) / (1 - b1^t),
    p = p - lr_c m / (sqrt(v) + eps),

and AdamW's decoupled decay then subtracts ``lr * wd * p_old`` with the
UNCORRECTED ``lr`` (skipped for parameters whose name
``apply_decay_param_fun`` rejects). ``Adam(weight_decay=c)`` is coupled
L2 (``g + c p``), as there.

The functional API is the JAX package's: ``init(params)`` builds the
state (a step counter and per-parameter ``m``/``v``) for a name-keyed
dict of parameters, and ``apply_gradients(params, grads, state, ok)``
updates them. Here the update is IN PLACE on the parameter and moment
tensors (no second copy of the model); the step counter is a device
tensor, and ``ok`` (a 0-d bool device tensor) selects between the new
and the old values on the device, so a train step's skip guard costs no
host sync. The learning rate is a float (schedulers are not ported).

The fused routes, under the JAX package's conditions: with the
``fused_adam`` flag every leaf whose ``p``, ``m`` and ``v`` are fp32
takes the leaf variant of the Adam kernel; else, with
``use_pallas_adam``, every leaf whose ``p`` and ``m`` are fp32 and that
has at least 1024 elements takes its flat variant. Each route updates
all its leaves of a step in one ``kernels.maybe_fused_adam`` call (one
launch on the card, the plain version on the CPU), AdamW's decay and the
skip guard folded in; the other leaves take the unfused update. Coupled
L2 is added to ``g`` before either.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import kernels
from ..flags import GLOBAL_FLAGS
from ..kernels import fused_adam as _adam

__all__ = ["Adam", "AdamW"]

# the use_pallas_adam route's least leaf size (the JAX package's)
_FLAT_MIN_NUMEL = 1024


class Adam:
    """Paddle Adam (``adam_op.h``): see the module note."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: Optional[float] = None) -> None:
        self.learning_rate = float(learning_rate)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "slots": {n: {"m": torch.zeros_like(p),
                              "v": torch.zeros_like(p)}
                          for n, p in params.items()}}

    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, Optional[torch.Tensor]],
                        state: dict,
                        ok: Optional[torch.Tensor] = None) -> None:
        """One update of every parameter with a gradient, in place. With
        ``ok`` given, everything keeps its old value where it is False,
        the step counter included. A parameter whose gradient is None (or
        missing) is skipped, moments and decay included: a direct caller
        gets that. ``static.TrainStep`` never passes None: it gives a
        parameter the loss does not reach a zero gradient, as JAX does, so
        AdamW decays it and its moments decay."""
        step = state["step"] + 1
        step_f = step.to(torch.float32)
        lr_c = self.learning_rate * torch.sqrt(
            1.0 - torch.pow(self.beta2, step_f)) \
            / (1.0 - torch.pow(self.beta1, step_f))
        fused_leaf = GLOBAL_FLAGS.get("fused_adam")
        fused_flat = GLOBAL_FLAGS.get("use_pallas_adam")
        # variant -> leaves: the kernel's "leaf" and "flat" routes, and
        # None, the unfused update (the leaf variant's plain version)
        routes = {"leaf": [], "flat": [], None: []}
        for name, p in params.items():
            g = grads.get(name)
            if g is None:
                continue
            if self.weight_decay:
                g = g + self.weight_decay * p
            slots = state["slots"][name]
            fp32 = [t.dtype == torch.float32
                    for t in (p, slots["m"], slots["v"])]
            if fused_leaf and all(fp32):
                route = "leaf"
            elif fused_flat and fp32[0] and fp32[1] \
                    and p.numel() >= _FLAT_MIN_NUMEL:
                route = "flat"
            else:
                route = None
            routes[route].append((p, g, slots, self._decay_coeff(name)))
        for variant, leaves in routes.items():
            if not leaves:
                continue
            coeffs = [c for *_, c in leaves]
            args = ([p for p, *_ in leaves], [g for _, g, *_ in leaves],
                    [s["m"] for *_, s, _ in leaves],
                    [s["v"] for *_, s, _ in leaves],
                    [c is not None for c in coeffs], lr_c, self.beta1,
                    self.beta2, self.epsilon,
                    next((c for c in coeffs if c is not None), 0.0), ok)
            if variant is None:
                _adam.adam_multi_plain(*args)
            else:
                kernels.maybe_fused_adam(*args, variant)
        state["step"] = step if ok is None \
            else torch.where(ok, step, state["step"])

    def _decay_coeff(self, name: str) -> Optional[float]:
        """The decoupled decay coefficient ``lr * wd`` of parameter
        ``name``, or None for no decay (always None for Adam)."""
        return None


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr * wd * p_old`` after
    the Adam step, with the uncorrected ``lr``; parameters whose name
    ``apply_decay_param_fun`` maps to False are not decayed."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]]
                 = None) -> None:
        super().__init__(learning_rate, beta1, beta2, epsilon)
        self.decoupled_weight_decay = weight_decay
        self.apply_decay_param_fun = apply_decay_param_fun

    def _decay_coeff(self, name):
        fn = self.apply_decay_param_fun
        if fn is not None and not fn(name):
            return None
        return self.learning_rate * self.decoupled_weight_decay
