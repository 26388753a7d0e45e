"""Layers of the GPT and BERT paths as ``torch.nn.Module``s.

Counterparts of ``paddle_tpu.nn.layers.common`` (Linear, Embedding,
Dropout, Dropout2D, AlphaDropout, Flatten, Identity, Upsample, Pad2D,
CosineSimilarity, Bilinear, PReLU, Maxout and the activation layers
under the JAX names: GELU, Tanh and ReLU here, the rest made by
``_activation_layer`` over ``ops.activation``), the container
``Sequential``,
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
from ..ops import activation as _act
from ..ops import nn_functional as _nnf
from ..ops.loss import _reduce
from . import functional as F
from . import initializer as I
from .layer import Layer
# a module reference: kernels imports nn.functional, so the two packages
# may be mid-import when this line runs; attributes resolve at call time
from .. import kernels

__all__ = ["Linear", "Embedding", "Dropout", "GELU", "Tanh", "ReLU",
           "Sequential", "LayerNorm", "FusedLinearCrossEntropy",
           "Flatten", "Identity", "Dropout2D", "AlphaDropout", "Upsample",
           "Pad2D", "CosineSimilarity", "Bilinear", "PReLU", "Maxout",
           "ReLU6", "LeakyReLU", "ELU", "SELU", "CELU", "Sigmoid",
           "LogSigmoid", "Hardsigmoid", "Hardswish", "Hardshrink",
           "Softshrink", "Hardtanh", "Tanhshrink", "Softplus", "Softsign",
           "Swish", "Silu", "Mish", "ThresholdedReLU", "LogSoftmax",
           "Softmax", "GLU"]


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
    """A lookup ``weight[ids]``; rows at ``padding_idx`` read as zeros.
    ``sparse`` is accepted and changes nothing, as in the JAX package:
    the autograd gradient is dense, and the row-sparse update takes an
    ``ops.sparse.embedding_grad`` built from it."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, sparse: bool = False,
                 weight_attr=None, name=None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = I.make_param(weight_attr, I.XavierNormal(),
                                   (num_embeddings, embedding_dim),
                                   device=device, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight)
        if self.padding_idx is not None:
            out = out * (ids != self.padding_idx)[..., None].to(out.dtype)
        return out


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


class Dropout2D(nn.Module):
    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nnf.dropout2d(x, self.p, training=self.training)


class AlphaDropout(nn.Module):
    def __init__(self, p: float = 0.5) -> None:
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nnf.alpha_dropout(x, self.p, training=self.training)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False) -> None:
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nnf.interpolate(x, self.size, self.scale_factor, self.mode,
                                self.align_corners)


class Pad2D(Layer):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCHW") -> None:
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _nnf.pad2d(x, self.padding, self.mode, self.value,
                          self.data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis: int = 1, eps: float = 1e-8) -> None:
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return _nnf.cosine_similarity(x1, x2, self.axis, self.eps)


class Bilinear(Layer):
    """(ref: bilinear_tensor_product_op.cc) ``out[b, k] = x1[b] W[k]
    x2[b]^T + bias[k]``, W ``[out, in1, in2]`` Xavier-uniform."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, weight_attr=None, bias_attr=None,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.weight = I.make_param(
            weight_attr, I.XavierUniform(),
            (out_features, in1_features, in2_features), device=device,
            generator=generator)
        self.bias = None if bias_attr is False else I.make_param(
            bias_attr, I.Constant(0.0), (out_features,), device=device,
            generator=generator)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        from ..ops.math import bilinear_tensor_product
        return bilinear_tensor_product(x1, x2, self.weight, self.bias)


class PReLU(Layer):
    def __init__(self, num_parameters: int = 1, init: float = 0.25,
                 device=None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.full(
            (num_parameters,), init, device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if w.shape[0] > 1:
            w = w.reshape((1, -1) + (1,) * (x.ndim - 2))
        return _act.prelu(x, w)


class Maxout(Layer):
    def __init__(self, groups: int, axis: int = 1) -> None:
        super().__init__()
        self.groups = groups
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _act.maxout(x, self.groups, self.axis)


def _activation_layer(fn_name: str, **defaults):
    """A layer calling ``ops.activation.<fn_name>(x, **kwargs)``, its
    keyword arguments given at construction."""
    fn = getattr(_act, fn_name)

    class _Act(Layer):
        def __init__(self, **kwargs) -> None:
            super().__init__()
            self.kwargs = {**defaults, **kwargs}

        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return fn(x, **self.kwargs)

    _Act.__name__ = _Act.__qualname__ = "".join(
        s.capitalize() for s in fn_name.split("_"))
    return _Act


ReLU6 = _activation_layer("relu6")
LeakyReLU = _activation_layer("leaky_relu")
ELU = _activation_layer("elu")
SELU = _activation_layer("selu")
CELU = _activation_layer("celu")
Sigmoid = _activation_layer("sigmoid")
LogSigmoid = _activation_layer("logsigmoid")
Hardsigmoid = _activation_layer("hard_sigmoid")
Hardswish = _activation_layer("hard_swish")
Hardshrink = _activation_layer("hard_shrink")
Softshrink = _activation_layer("soft_shrink")
Hardtanh = _activation_layer("hard_tanh")
Tanhshrink = _activation_layer("tanh_shrink")
Softplus = _activation_layer("softplus")
Softsign = _activation_layer("softsign")
Swish = _activation_layer("swish")
Silu = _activation_layer("swish")
Mish = _activation_layer("mish")
ThresholdedReLU = _activation_layer("thresholded_relu")
LogSoftmax = _activation_layer("log_softmax")
Softmax = _activation_layer("softmax")
GLU = _activation_layer("glu")
