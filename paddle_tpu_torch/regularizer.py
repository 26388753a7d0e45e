"""Weight-decay regularizers.

Counterpart of ``paddle_tpu.regularizer``: a regularizer is called as
``reg(param, grad)`` and returns the decayed gradient. The optimizer
applies it after gradient clipping, to the fp32 gradient and the fp32
parameter (its master copy for a bf16/fp16 parameter).
"""

from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay",
           "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def __call__(self, param: torch.Tensor,
                 grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """``grad + coeff * param``."""

    def __init__(self, coeff: float = 0.0) -> None:
        self.coeff = coeff

    def __call__(self, param, grad):
        return grad + self.coeff * param


class L1Decay(WeightDecayRegularizer):
    """``grad + coeff * sign(param)``."""

    def __init__(self, coeff: float = 0.0) -> None:
        self.coeff = coeff

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param)


# the fluid spellings
L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
