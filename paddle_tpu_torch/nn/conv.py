"""Convolution and pooling layers of the ResNet path.

Counterparts of ``paddle_tpu.nn.layers.conv``'s ``Conv2D``,
``MaxPool2D``, ``AvgPool2D`` and ``AdaptiveAvgPool2D``, over
``ops.nn_functional``. ``Conv2D`` stores its weight OIHW ``[out, in /
groups, kh, kw]`` whatever the activation layout (checkpoints are
layout-independent, as in JAX), Kaiming-uniform initialised (fan in,
ReLU gain), with a zero bias unless ``bias_attr=False``. Each layer is
an ``nn.layer.Layer``; ``device`` None means ``cuda``
(``core.place.resolve_device``), and parameters draw from ``generator``
(the bits differ from JAX's: tests move weights across).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..core.place import resolve_device
from ..ops import nn_functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]

IntOrPair = Union[int, Sequence[int]]


def _pair(v: IntOrPair):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2D(Layer):
    """2-D convolution with OIHW weights (see the module note)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrPair, stride: IntOrPair = 1,
                 padding=0, dilation: IntOrPair = 1, groups: int = 1,
                 weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        self.weight = I.make_param(
            weight_attr, I.KaimingUniform(),
            (out_channels, in_channels // groups) + self.kernel_size,
            device=device, generator=generator)
        self.bias = None if bias_attr is False else I.make_param(
            bias_attr, I.Constant(0.0), (out_channels,), device=device,
            generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format, weight_format="OIHW")


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode: bool = False,
                 data_format: str = "NCHW") -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.data_format)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode: bool = False, exclusive: bool = True,
                 data_format: str = "NCHW") -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format: str = "NCHW") -> None:
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
