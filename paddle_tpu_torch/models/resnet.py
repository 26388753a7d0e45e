"""The ResNet family (18/34/50/101/152, ResNeXt-50 32x4d).

Counterpart of ``paddle_tpu.models.resnet``: ``BasicBlock``,
``BottleneckBlock`` (grouped 3x3 convs for ResNeXt) and ``ResNet`` in
NCHW (the default) or NHWC (``data_format="NHWC"``: activations
channels-last end to end, weights OIHW either way), with the JAX
model's parameter and buffer names (``conv1.weight``, ``bn1._mean``,
``layer1.0.downsample.0.weight``, ...), so a JAX ``param_dict()`` and
``buffer_dict()`` load by name (``convert.load_jax_params``). Weights are
drawn on ``device`` (None means ``cuda``) from a generator seeded with
``seed``.

Two flags, as in JAX:

- ``resnet_space_to_depth_stem`` (or the model's ``s2d_stem``, True or
  False, which overrides it): the 7x7/stride-2 stem conv as the exact
  4x4/stride-1 conv over the 2x2 space-to-depth fold of an NHWC input
  with even sides, the weight rearranged at call time
  (:func:`_space_to_depth_stem`); the parameters are unchanged.
- ``resnet_block_remat``: in training each residual block runs under a
  non-reentrant ``torch.utils.checkpoint``, its activations recomputed
  in the backward. The recompute runs the block's BatchNorms again on
  the same input, which gives the same output but would move their
  running statistics a second time: it runs them under
  ``nn.norm.frozen_statistics``, so the statistics move once a step and
  a step with remat equals one without bit for bit (the JAX model
  threads them through ``jax.checkpoint`` for the same reason).
"""

from __future__ import annotations

from typing import List, Optional, Type

import torch
import torch.nn.functional as tF
from torch.utils.checkpoint import checkpoint

from ..core.place import resolve_device
from ..flags import GLOBAL_FLAGS
from ..nn.conv import AdaptiveAvgPool2D, Conv2D, MaxPool2D
from ..nn.layer import Layer
from ..nn.layers import Flatten, Linear, ReLU, Sequential
from ..nn.norm import BatchNorm2D, frozen_statistics
from ..ops import nn_functional as F

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "resnext50_32x4d"]


def _space_to_depth_stem(x: torch.Tensor,
                         weight_oihw: torch.Tensor) -> torch.Tensor:
    """The 7x7/stride-2 stem conv (padding 3) of NHWC ``x`` with even
    sides, computed exactly as a 4x4/stride-1 conv over 12 channels: the
    kernel padded to 8x8 (a zero row and column at index 0), each 2x2
    input block folded into channels ``(p, q, c)``, padding ``((2, 1),
    (2, 1))``::

        out[n,i,j,o] = sum_{a,b,p,q,c} s2d(x)[n,i+a-2,j+b-2,(p,q,c)]
                       * W'[2a+p, 2b+q, c, o]
    """
    n, h, w, c = x.shape
    xs = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, h // 2, w // 2, 4 * c)
    # OIHW [64, 3, 7, 7] -> HWIO [7, 7, 3, 64] -> zero-padded [8, 8, 3, 64]
    wk = tF.pad(weight_oihw.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
    kh, kw, ci, co = wk.shape
    wk = wk.reshape(kh // 2, 2, kw // 2, 2, ci, co).permute(0, 2, 1, 3, 4, 5) \
        .reshape(kh // 2, kw // 2, 4 * ci, co)
    return F.conv2d(xs, wk.to(x.dtype), None, 1, [2, 1, 2, 1],
                    data_format="NHWC", weight_format="HWIO")


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[Layer] = None,
                 data_format: str = "NCHW", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(data_format=data_format, device=device)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, generator=generator, **kw)
        self.bn1 = BatchNorm2D(planes, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            generator=generator, **kw)
        self.bn2 = BatchNorm2D(planes, **kw)
        if downsample is not None:
            self.downsample = downsample
        self.has_downsample = downsample is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.has_downsample:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[Layer] = None, groups: int = 1,
                 base_width: int = 64, data_format: str = "NCHW",
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        kw = dict(data_format=data_format, device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            generator=generator, **kw)
        self.bn1 = BatchNorm2D(width, **kw)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias_attr=False,
                            generator=generator, **kw)
        self.bn2 = BatchNorm2D(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, generator=generator, **kw)
        self.bn3 = BatchNorm2D(planes * self.expansion, **kw)
        self.relu = ReLU()
        if downsample is not None:
            self.downsample = downsample
        self.has_downsample = downsample is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.has_downsample:
            identity = self.downsample(x)
        return self.relu(out + identity)


def _remat_block(block: Layer, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` with its activations recomputed in the backward; the
    recompute (every call after the first) writes no BatchNorm
    statistics."""
    calls = [0]

    def run(inp: torch.Tensor) -> torch.Tensor:
        calls[0] += 1
        if calls[0] > 1:
            with frozen_statistics():
                return block(inp)
        return block(inp)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class ResNet(Layer):
    def __init__(self, block: Type, layers: List[int],
                 num_classes: int = 1000, groups: int = 1,
                 width_per_group: int = 64, data_format: str = "NCHW",
                 device=None, seed: int = 0) -> None:
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got "
                             f"{data_format!r}")
        dev = resolve_device(device)
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))
        self._kw = dict(data_format=data_format, device=dev)
        self.data_format = data_format
        # None follows resnet_space_to_depth_stem; True/False pins it
        self.s2d_stem: Optional[bool] = None
        self.inplanes = 64
        self.groups = groups
        self.base_width = width_per_group
        self.conv1 = Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                            generator=self._gen, **self._kw)
        self.bn1 = BatchNorm2D(64, **self._kw)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, 2, 1, data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], 2)
        self.layer3 = self._make_layer(block, 256, layers[2], 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 2)
        self.avgpool = AdaptiveAvgPool2D(1, data_format=data_format)
        self.flatten = Flatten()
        self.fc = Linear(512 * block.expansion, num_classes, device=dev,
                         generator=self._gen)

    def _block(self, block: Type, inplanes: int, planes: int,
               stride: int = 1, downsample=None) -> Layer:
        if block is BottleneckBlock:
            return block(inplanes, planes, stride, downsample,
                         groups=self.groups, base_width=self.base_width,
                         generator=self._gen, **self._kw)
        return block(inplanes, planes, stride, downsample,
                     generator=self._gen, **self._kw)

    def _make_layer(self, block: Type, planes: int, blocks: int,
                    stride: int = 1) -> Sequential:
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, generator=self._gen,
                       **self._kw),
                BatchNorm2D(planes * block.expansion, **self._kw))
        layers = [self._block(block, self.inplanes, planes, stride,
                              downsample)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(self._block(block, self.inplanes, planes))
        return Sequential(*layers)

    def _run_stage(self, seq: Sequential, x: torch.Tensor) -> torch.Tensor:
        """One ``layerN`` stage; each block rematerialised under
        ``resnet_block_remat`` in training (see the module note)."""
        if not (self.training and torch.is_grad_enabled()
                and GLOBAL_FLAGS.get("resnet_block_remat")):
            return seq(x)
        for block in seq:
            x = _remat_block(block, x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        use_s2d = self.s2d_stem if self.s2d_stem is not None \
            else GLOBAL_FLAGS.get("resnet_space_to_depth_stem")
        if (use_s2d and self.data_format == "NHWC"
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            x = _space_to_depth_stem(x, self.conv1.weight)
        else:
            x = self.conv1(x)
        x = self.maxpool(self.relu(self.bn1(x)))
        x = self._run_stage(self.layer1, x)
        x = self._run_stage(self.layer2, x)
        x = self._run_stage(self.layer3, x)
        x = self._run_stage(self.layer4, x)
        x = self.flatten(self.avgpool(x))
        return self.fc(x)


def resnet18(num_classes: int = 1000, data_format: str = "NCHW",
             **kw) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes,
                  data_format=data_format, **kw)


def resnet34(num_classes: int = 1000, data_format: str = "NCHW",
             **kw) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes,
                  data_format=data_format, **kw)


def resnet50(num_classes: int = 1000, data_format: str = "NCHW",
             **kw) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes,
                  data_format=data_format, **kw)


def resnet101(num_classes: int = 1000, data_format: str = "NCHW",
              **kw) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes,
                  data_format=data_format, **kw)


def resnet152(num_classes: int = 1000, data_format: str = "NCHW",
              **kw) -> ResNet:
    return ResNet(BottleneckBlock, [3, 8, 36, 3], num_classes,
                  data_format=data_format, **kw)


def resnext50_32x4d(num_classes: int = 1000, data_format: str = "NCHW",
                    **kw) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, groups=32,
                  width_per_group=4, data_format=data_format, **kw)
