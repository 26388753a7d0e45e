"""Plain attention.

Counterpart of ``paddle_tpu.ops.attention.scaled_dot_product_attention``:
materialised scores, an optional causal (bottom-right aligned) fill, a
boolean keep mask or an additive mask, softmax, dropout on the
probabilities, and the value product. This is where
``kernels.maybe_flash_attention`` sends what its gate keeps from the
flash kernels (eval, short sequences, masks other than [B, 1, 1, Tk]).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import random as _random

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 scale: Optional[float] = None,
                                 causal: bool = False,
                                 dropout_p: float = 0.0,
                                 training: bool = False) -> torch.Tensor:
    """q, k, v ``[B, H, T, D]`` (or any ``[..., T, D]``); ``mask``
    broadcasts to ``[..., Tq, Tk]``: additive if float, a keep mask if
    bool. Dropout (training only) draws from the ``dropout`` stream."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qd,...kd->...qk", q, k) * scale
    lowest = torch.finfo(logits.dtype).min
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=logits.device).tril(tk - tq)
        logits = logits.masked_fill(~keep, lowest)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, lowest)
        else:
            logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        gen = _random.next_generator("dropout", q.device)
        keep = torch.rand(weights.shape, generator=gen,
                          device=weights.device) < (1.0 - dropout_p)
        weights = torch.where(keep, weights / (1.0 - dropout_p),
                              torch.zeros_like(weights))
    return torch.einsum("...qk,...kd->...qd", weights, v)
