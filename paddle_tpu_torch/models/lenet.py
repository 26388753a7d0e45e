"""LeNet-5 for MNIST.

Counterpart of ``paddle_tpu.models.lenet``: two conv + ReLU + 2x2
max-pool stages and three linear layers, with the JAX model's parameter
names (``features.0.weight``, ``fc.4.bias``, ...). Weights are drawn on
``device`` (None: the card) from a generator seeded with ``seed``.
"""

from __future__ import annotations

import torch

from ..core.place import resolve_device
from ..nn.conv import Conv2D, MaxPool2D
from ..nn.layer import Layer
from ..nn.layers import Flatten, Linear, ReLU, Sequential

__all__ = ["LeNet"]


class LeNet(Layer):
    """images [B, 1, 28, 28] -> logits [B, num_classes]."""

    def __init__(self, num_classes: int = 10, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=torch.Generator(
            device=dev).manual_seed(int(seed)))
        self.features = Sequential(
            Conv2D(1, 6, 5, padding=2, **kw), ReLU(), MaxPool2D(2, 2),
            Conv2D(6, 16, 5, **kw), ReLU(), MaxPool2D(2, 2))
        self.flatten = Flatten()
        self.fc = Sequential(
            Linear(16 * 5 * 5, 120, **kw), ReLU(), Linear(120, 84, **kw),
            ReLU(), Linear(84, num_classes, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.flatten(self.features(x)))
