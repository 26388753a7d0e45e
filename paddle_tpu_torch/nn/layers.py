"""Layers of the GPT and BERT paths as ``torch.nn.Module``s.

Counterparts of ``paddle_tpu.nn.layers.common`` (Linear, Embedding,
Dropout, Flatten, Identity), the activation layers (GELU, Tanh, ReLU),
the container ``Sequential``,
``paddle_tpu.nn.layers.norm.LayerNorm`` and
``paddle_tpu.nn.layers.loss.FusedLinearCrossEntropy``. Parameter names
(``weight``, ``bias``) and shapes match the JAX layers, so a JAX
``param_dict()`` loads by name (see ``paddle_tpu_torch.convert``).
``Linear``, ``Embedding`` and ``LayerNorm`` are ``nn.layer.Layer``s and
take ``weight_attr``/``bias_attr`` as the JAX layers do (an initializer,
a number or a ``ParamAttr``; ``nn.initializer.make_param``). Each layer
initialises itself on ``device`` from an explicit ``torch.Generator``
with the JAX layer's scheme (Xavier-uniform Linear weights,
Xavier-normal embeddings, zero biases, unit LayerNorm scale); the bits
differ from JAX's, so tests move weights across instead.
``device`` None means ``cuda`` (``core.place.resolve_device``), which
raises without a GPU; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..core.place import resolve_device
from ..ops.loss import _reduce
from . import functional as F
from . import initializer as I
from .layer import Layer
# a module reference: kernels imports nn.functional, so the two packages
# may be mid-import when this line runs; attributes resolve at call time
from .. import kernels

__all__ = ["Linear", "Embedding", "Dropout", "GELU", "Tanh", "ReLU",
           "Sequential", "LayerNorm", "FusedLinearCrossEntropy",
           "Flatten", "Identity"]


class Linear(Layer):
    """``y = x W + b`` with ``W`` ``[in, out]`` (reference fc layout).
    ``weight_attr``/``bias_attr`` as the JAX layer takes them
    (``nn.initializer.make_param``; ``bias_attr=False`` means no bias)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        self.out_features = out_features
        self.weight = I.make_param(weight_attr, I.XavierUniform(),
                                   (in_features, out_features),
                                   device=device, generator=generator)
        self.bias = None if bias_attr is False else I.make_param(
            bias_attr, I.Constant(0.0), (out_features,), device=device,
            generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = I.make_param(weight_attr, I.XavierNormal(),
                                   (num_embeddings, embedding_dim),
                                   device=device, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class Dropout(nn.Module):
    """Paddle's ``upscale_in_train`` dropout, active only while the
    module is in training mode (``self.training``)."""

    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, training=self.training)


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x)


class Tanh(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x)


class ReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class Flatten(Layer):
    """``x`` with dims ``start_axis`` to ``stop_axis`` merged into one."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1) -> None:
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Sequential(nn.Sequential):
    """``torch.nn.Sequential`` (sublayers named ``0``, ``1``, ... as the
    JAX ``Sequential`` names them), also built from one list of
    ``(name, layer)`` pairs, as the JAX one can be."""

    def __init__(self, *layers) -> None:
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) \
                and layers[0] and isinstance(layers[0][0], (list, tuple)):
            super().__init__(OrderedDict(layers[0]))
        else:
            super().__init__(*layers)


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` dims, routed
    through ``kernels.maybe_layer_norm`` (the CUDA kernel for a CUDA
    tensor, the plain version for a CPU one). ``weight_attr``/
    ``bias_attr`` False leave the scale at 1 / the shift at 0 (a constant
    buffer, not a parameter)."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        for name, attr, fill in (("weight", weight_attr, 1.0),
                                 ("bias", bias_attr, 0.0)):
            if attr is False:
                self.register_buffer(name, torch.full(
                    self.normalized_shape, fill, device=device),
                    persistent=False)
            else:
                setattr(self, name, I.make_param(
                    attr, I.Constant(fill), self.normalized_shape,
                    device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return kernels.maybe_layer_norm(
            x, self.weight, self.bias, self.epsilon,
            x.ndim - len(self.normalized_shape))


class FusedLinearCrossEntropy(nn.Module):
    """``loss = xent(hidden @ weight.T + bias, label)`` as one loss-region
    op through ``kernels.maybe_fused_linear_xent`` (the fused kernels
    under the ``fused_softmax_xent`` flag, the composed projection and
    ``ops.loss`` otherwise), reduced as Paddle reduces it (``"mean"``
    over every position, ignored ones counted as 0)."""

    def __init__(self, ignore_index: int = -100,
                 reduction: str = "mean") -> None:
        super().__init__()
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, hidden: torch.Tensor, weight: torch.Tensor,
                label: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        loss = kernels.maybe_fused_linear_xent(
            hidden, weight, bias, label, ignore_index=self.ignore_index)
        return _reduce(loss, self.reduction)
