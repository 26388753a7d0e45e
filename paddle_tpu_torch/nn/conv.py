"""Convolution and pooling layers.

Counterparts of ``paddle_tpu.nn.layers.conv``: ``Conv1D``, ``Conv2D``,
``Conv3D``, ``Conv2DTranspose``, the 2-D and 3-D max and average pools,
the adaptive 2-D pools, ``Unfold``, ``Fold`` and ``PixelShuffle``, over
``ops.nn_functional``. ``Conv2D`` stores its weight OIHW ``[out, in /
groups, kh, kw]`` whatever the activation layout (checkpoints are
layout-independent, as in JAX); ``Conv1D``/``Conv3D`` ``[out, in /
groups, *k]``, ``Conv2DTranspose`` ``[in, out / groups, kh, kw]``;
each Kaiming-uniform initialised (fan in, ReLU gain), with a zero bias
unless ``bias_attr=False``. ``data_format`` is taken where the JAX
layer takes it (``Conv1D`` accepts it and runs NCL, as there). Each layer is
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

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose", "MaxPool2D",
           "AvgPool2D", "MaxPool3D", "AvgPool3D", "AdaptiveAvgPool2D",
           "AdaptiveMaxPool2D", "Unfold", "Fold", "PixelShuffle"]

IntOrPair = Union[int, Sequence[int]]


def _pair(v: IntOrPair, n: int = 2):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvNd(Layer):
    """The weight ``[out, in / groups, *k]`` (``[in, out / groups, *k]``
    when ``transpose``) and the bias of a convolution layer."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride, padding, dilation, groups: int, weight_attr,
                 bias_attr, spatial: int, transpose: bool = False,
                 output_padding: IntOrPair = 0, data_format: str = "NCHW",
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size, spatial)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        shape = ((in_channels, out_channels // groups) if transpose
                 else (out_channels, in_channels // groups)) \
            + self.kernel_size
        self.weight = I.make_param(weight_attr, I.KaimingUniform(), shape,
                                   device=device, generator=generator)
        self.bias = None if bias_attr is False else I.make_param(
            bias_attr, I.Constant(0.0), (out_channels,), device=device,
            generator=generator)


class Conv1D(_ConvNd):
    """NCL convolution (``data_format`` is accepted, as the JAX layer
    accepts it)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None, data_format: str = "NCL",
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         1, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def first(v):
            return v if isinstance(v, (int, str)) else v[0]
        return F.conv1d(x, self.weight, self.bias, first(self.stride),
                        first(self.padding), first(self.dilation),
                        self.groups)


class Conv3D(_ConvNd):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 weight_attr=None, bias_attr=None,
                 data_format: str = "NCDHW", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         3, data_format=data_format, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, output_padding=0, dilation=1,
                 groups: int = 1, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         2, transpose=True, output_padding=output_padding,
                         data_format=data_format, device=device,
                         generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups,
                                  data_format=self.data_format)


class Conv2D(_ConvNd):
    """2-D convolution with OIHW weights (see the module note)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrPair, stride: IntOrPair = 1,
                 padding=0, dilation: IntOrPair = 1, groups: int = 1,
                 weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         2, data_format=data_format, device=device,
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


class MaxPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode: bool = False) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode)


class AvgPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 ceil_mode: bool = False) -> None:
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size) -> None:
        super().__init__()
        self.output_size = output_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.adaptive_max_pool2d(x, self.output_size)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0,
                 dilations=1) -> None:
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1) -> None:
        super().__init__()
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor: int,
                 data_format: str = "NCHW") -> None:
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.manipulation import pixel_shuffle
        return pixel_shuffle(x, self.upscale_factor, self.data_format)
