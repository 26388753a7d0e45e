"""Plain functional ops of the GPT path.

Counterparts of ``paddle_tpu.ops.nn_functional`` (linear, embedding,
layer_norm) and ``paddle_tpu.ops.activation.gelu``. ``linear`` keeps
the reference fc convention: the weight is ``[in, out]``, never torch's
``[out, in]``, so weights move across from the JAX package untouched.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["linear", "embedding", "gelu", "layer_norm"]


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
