"""Layers of the GPT path as ``torch.nn.Module``s.

Counterparts of ``paddle_tpu.nn.layers.common`` (Linear, Embedding,
GELU) and ``paddle_tpu.nn.layers.norm.LayerNorm``. Parameter names
(``weight``, ``bias``) and shapes match the JAX layers, so a JAX
``param_dict()`` loads by name (see ``paddle_tpu_torch.convert``). Each
layer initialises itself on ``device`` from an explicit
``torch.Generator`` with the JAX layer's scheme (Xavier-uniform Linear
weights, Xavier-normal embeddings, zero biases, unit LayerNorm scale);
the bits differ from JAX's, so tests move weights across instead.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from . import functional as F
# a module reference: kernels imports nn.functional, so the two packages
# may be mid-import when this line runs; attributes resolve at call time
from .. import kernels

__all__ = ["Linear", "Embedding", "GELU", "LayerNorm"]


def _param(shape, device, fill: Optional[float] = None) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class Linear(nn.Module):
    """``y = x W + b`` with ``W`` ``[in, out]`` (reference fc layout)."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _param((in_features, out_features), device)
        limit = math.sqrt(6.0 / (in_features + out_features))
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)
        self.bias = _param((out_features,), device, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _param((num_embeddings, embedding_dim), device)
        std = math.sqrt(2.0 / (num_embeddings + embedding_dim))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims, routed
    through ``kernels.maybe_layer_norm`` (the CUDA kernel for a CUDA
    tensor, the plain version for a CPU one)."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 epsilon: float = 1e-5, device=None) -> None:
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = _param(self.normalized_shape, device, 1.0)
        self.bias = _param(self.normalized_shape, device, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return kernels.maybe_layer_norm(
            x, self.weight, self.bias, self.epsilon,
            x.ndim - len(self.normalized_shape))
