"""MobileNet V1 and V2.

Counterpart of ``paddle_tpu.models.mobilenet`` (the reference's hapi
``mobilenetv1.py``/``mobilenetv2.py``): depthwise-separable conv + BN +
ReLU6 blocks (V1); inverted residuals with a linear bottleneck (V2,
the paper's table 2), with ``scale`` widening every channel count
(``max(int(c * scale), 8)``) and the JAX parameter names
(``stem.0.weight``, ``blocks.3.conv.1.1._mean``, ``fc.weight``, ...).
The depthwise convolutions are grouped convolutions (cuDNN's on the
card). ``data_format="NHWC"`` runs the whole stack channels-last;
weights stay OIHW, so checkpoints are layout-independent. Weights are
drawn on ``device`` (None: the card) from a generator seeded with
``seed``.
"""

from __future__ import annotations

import torch

from ..core.place import resolve_device
from ..nn.conv import AdaptiveAvgPool2D, Conv2D
from ..nn.layer import Layer
from ..nn.layers import Linear, ReLU6, Sequential
from ..nn.norm import BatchNorm2D

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


def _conv_bn(in_c: int, out_c: int, kernel: int, stride: int = 1,
             padding: int = 0, groups: int = 1, data_format: str = "NCHW",
             **kw) -> Sequential:
    return Sequential(
        Conv2D(in_c, out_c, kernel, stride=stride, padding=padding,
               groups=groups, bias_attr=False, data_format=data_format,
               **kw),
        BatchNorm2D(out_c, data_format=data_format, device=kw["device"]),
        ReLU6())


def _check(data_format: str) -> None:
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")


def _kw(device, seed: int) -> dict:
    dev = resolve_device(device)
    return dict(device=dev,
                generator=torch.Generator(device=dev).manual_seed(int(seed)))


class _DepthwiseSeparable(Layer):
    def __init__(self, in_c: int, out_c: int, stride: int,
                 data_format: str = "NCHW", **kw) -> None:
        super().__init__()
        self.depthwise = _conv_bn(in_c, in_c, 3, stride=stride, padding=1,
                                  groups=in_c, data_format=data_format, **kw)
        self.pointwise = _conv_bn(in_c, out_c, 1, data_format=data_format,
                                  **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class MobileNetV1(Layer):
    def __init__(self, num_classes: int = 1000, scale: float = 1.0,
                 data_format: str = "NCHW", device=None,
                 seed: int = 0) -> None:
        super().__init__()
        _check(data_format)
        kw = _kw(device, seed)

        def c(ch: int) -> int:
            return max(int(ch * scale), 8)

        df = data_format
        cfg = [(c(32), c(64), 1), (c(64), c(128), 2), (c(128), c(128), 1),
               (c(128), c(256), 2), (c(256), c(256), 1),
               (c(256), c(512), 2), *[(c(512), c(512), 1)] * 5,
               (c(512), c(1024), 2), (c(1024), c(1024), 1)]
        self.stem = _conv_bn(3, c(32), 3, stride=2, padding=1,
                             data_format=df, **kw)
        self.blocks = Sequential(*[_DepthwiseSeparable(i, o, s,
                                                       data_format=df, **kw)
                                   for i, o, s in cfg])
        self.pool = AdaptiveAvgPool2D(1, data_format=df)
        self.fc = Linear(c(1024), num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pool(self.blocks(self.stem(x)))
        return self.fc(h.reshape(x.shape[0], -1))


class _InvertedResidual(Layer):
    """expand (1x1) -> depthwise (3x3) -> project (1x1, linear), with the
    residual when stride and widths allow."""

    def __init__(self, in_c: int, out_c: int, stride: int, expand: int,
                 data_format: str = "NCHW", **kw) -> None:
        super().__init__()
        df = data_format
        hidden = in_c * expand
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(_conv_bn(in_c, hidden, 1, data_format=df, **kw))
        layers.append(_conv_bn(hidden, hidden, 3, stride=stride, padding=1,
                               groups=hidden, data_format=df, **kw))
        layers.append(Conv2D(hidden, out_c, 1, bias_attr=False,
                             data_format=df, **kw))
        layers.append(BatchNorm2D(out_c, data_format=df,
                                  device=kw["device"]))
        self.conv = Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    # (expand, out_c, repeats, stride): the paper's table 2
    _CFG = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, num_classes: int = 1000, scale: float = 1.0,
                 data_format: str = "NCHW", device=None,
                 seed: int = 0) -> None:
        super().__init__()
        _check(data_format)
        kw = _kw(device, seed)

        def c(ch: int) -> int:
            return max(int(ch * scale), 8)

        df = data_format
        in_c = c(32)
        self.stem = _conv_bn(3, in_c, 3, stride=2, padding=1,
                             data_format=df, **kw)
        blocks = []
        for expand, out, reps, stride in self._CFG:
            for r in range(reps):
                blocks.append(_InvertedResidual(
                    in_c, c(out), stride if r == 0 else 1, expand,
                    data_format=df, **kw))
                in_c = c(out)
        self.blocks = Sequential(*blocks)
        last = max(c(1280), 1280) if scale > 1.0 else 1280
        self.head = _conv_bn(in_c, last, 1, data_format=df, **kw)
        self.pool = AdaptiveAvgPool2D(1, data_format=df)
        self.fc = Linear(last, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pool(self.head(self.blocks(self.stem(x))))
        return self.fc(h.reshape(x.shape[0], -1))


def mobilenet_v1(num_classes: int = 1000, scale: float = 1.0,
                 data_format: str = "NCHW", **kw) -> MobileNetV1:
    return MobileNetV1(num_classes=num_classes, scale=scale,
                       data_format=data_format, **kw)


def mobilenet_v2(num_classes: int = 1000, scale: float = 1.0,
                 data_format: str = "NCHW", **kw) -> MobileNetV2:
    return MobileNetV2(num_classes=num_classes, scale=scale,
                       data_format=data_format, **kw)
