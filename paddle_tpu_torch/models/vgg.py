"""VGG 11/13/16/19, with or without BatchNorm.

Counterpart of ``paddle_tpu.models.vgg`` (the reference's hapi
``make_layers`` configurations A/B/D/E): 3x3 conv (+ BN) + ReLU stacks
with 2x2 max pools, a 7x7 adaptive average pool and the 4096-4096
classifier with dropout, under the JAX parameter names
(``features.0.weight``, ``classifier.6.bias``, ...).
``data_format="NHWC"`` runs the conv stack channels-last and transposes
the pooled [B, 7, 7, 512] map back to channel-first order before the
flatten, so the classifier weights are the same in both layouts.
Weights are drawn on ``device`` (None: the card) from a generator
seeded with ``seed``.
"""

from __future__ import annotations

from typing import List, Union

import torch

from ..core.place import resolve_device
from ..nn.conv import AdaptiveAvgPool2D, Conv2D, MaxPool2D
from ..nn.layer import Layer
from ..nn.layers import Dropout, Linear, ReLU, Sequential
from ..nn.norm import BatchNorm2D

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19"]

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg: List[Union[int, str]], batch_norm: bool,
                 data_format: str = "NCHW", device=None,
                 generator=None) -> Sequential:
    layers: list = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2,
                                    data_format=data_format))
            continue
        layers.append(Conv2D(in_c, v, 3, padding=1, data_format=data_format,
                             device=device, generator=generator))
        if batch_norm:
            layers.append(BatchNorm2D(v, data_format=data_format,
                                      device=device))
        layers.append(ReLU())
        in_c = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features: Layer, num_classes: int = 1000,
                 dropout: float = 0.5, data_format: str = "NCHW",
                 device=None, generator=None) -> None:
        super().__init__()
        if data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"data_format must be NCHW or NHWC, got "
                             f"{data_format!r}")
        dev = resolve_device(device)
        kw = dict(device=dev, generator=generator)
        self.data_format = data_format
        self.features = features
        self.pool = AdaptiveAvgPool2D(7, data_format=data_format)
        self.classifier = Sequential(
            Linear(512 * 7 * 7, 4096, **kw), ReLU(), Dropout(dropout),
            Linear(4096, 4096, **kw), ReLU(), Dropout(dropout),
            Linear(4096, num_classes, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pool(self.features(x))
        if self.data_format == "NHWC":
            h = h.permute(0, 3, 1, 2)
        return self.classifier(h.reshape(x.shape[0], -1))


def _vgg(cfg: str, batch_norm: bool, num_classes: int,
         data_format: str = "NCHW", device=None, seed: int = 0) -> VGG:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return VGG(_make_layers(_CFGS[cfg], batch_norm, data_format, dev, gen),
               num_classes=num_classes, data_format=data_format,
               device=dev, generator=gen)


def vgg11(num_classes: int = 1000, batch_norm: bool = False,
          data_format: str = "NCHW", **kw) -> VGG:
    return _vgg("A", batch_norm, num_classes, data_format, **kw)


def vgg13(num_classes: int = 1000, batch_norm: bool = False,
          data_format: str = "NCHW", **kw) -> VGG:
    return _vgg("B", batch_norm, num_classes, data_format, **kw)


def vgg16(num_classes: int = 1000, batch_norm: bool = False,
          data_format: str = "NCHW", **kw) -> VGG:
    return _vgg("D", batch_norm, num_classes, data_format, **kw)


def vgg19(num_classes: int = 1000, batch_norm: bool = False,
          data_format: str = "NCHW", **kw) -> VGG:
    return _vgg("E", batch_norm, num_classes, data_format, **kw)
