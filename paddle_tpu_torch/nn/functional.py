"""Plain functional ops of the GPT and BERT paths.

Counterparts of ``paddle_tpu.ops.nn_functional`` (linear, embedding,
layer_norm, dropout) and ``paddle_tpu.ops.activation``'s ``gelu`` and
``relu``. ``linear``
keeps the reference fc convention: the weight is ``[in, out]``, never
torch's ``[out, in]``, so weights move across from the JAX package
untouched.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import random as _random

__all__ = ["linear", "embedding", "gelu", "relu", "layer_norm",
           "dropout"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight (+ bias)`` with ``weight`` ``[in, out]``."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return weight[ids]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)`` (GPT-2's
    published tanh form is not what the JAX package computes)."""
    return torch.nn.functional.gelu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def dropout(x: torch.Tensor, p: float = 0.5,
            training: bool = True) -> torch.Tensor:
    """Paddle's ``upscale_in_train`` dropout: ``where(keep, x / (1 - p),
    0)`` in training, identity in eval. Keep is a Bernoulli(1 - p) draw
    from the ``dropout`` stream of ``core.random``."""
    if not training or p == 0.0:
        return x
    gen = _random.next_generator("dropout", x.device)
    keep = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - p)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, epsilon: float = 1e-5,
               begin_norm_axis: int = -1) -> torch.Tensor:
    """LayerNorm over dims ``[begin_norm_axis:)``: population variance
    (``jnp.var``) with eps inside the rsqrt."""
    if begin_norm_axis < 0:
        begin_norm_axis += x.ndim
    dims = tuple(range(begin_norm_axis, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=dims, keepdim=True)
    out = xc * torch.rsqrt(var + epsilon)
    norm_shape = x.shape[begin_norm_axis:]
    if weight is not None:
        out = out * weight.reshape(norm_shape)
    if bias is not None:
        out = out + bias.reshape(norm_shape)
    return out
