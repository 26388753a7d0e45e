"""DCGAN: a generator, a discriminator and their alternating step.

Counterpart of ``paddle_tpu.models.gan``: ``Generator`` (z -> a
[B, 1, 28, 28] image through a linear layer and two transposed
convolutions) and ``Discriminator`` (two strided convolutions and a
logit), with the JAX parameter and buffer names, and ``GANTrainStep``:
each call one discriminator update, then one generator update against
the updated discriminator, as the JAX step compiles them.

The step's order, as in JAX: ``z`` (standard normal ``[B, z_dim]``, the
first draw of each call from ``generator``) -> ``fake = G(z)`` with
G's batch statistics not written -> ``d_loss = BCE(D(real), 1) +
BCE(D(fake), 0)`` (D's statistics written by both forwards) -> the D
update -> ``g_loss = BCE(D'(G(z)), 1)`` with D's statistics not written
and G's written once -> the G update. The draws cannot be threefry's;
``generator`` is seeded with ``seed``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.place import resolve_device
from ..nn.conv import Conv2D, Conv2DTranspose
from ..nn.layer import Layer
from ..nn.layers import Linear
from ..nn.norm import BatchNorm1D, BatchNorm2D, frozen_statistics
from ..ops.activation import leaky_relu
from ..ops.loss import binary_cross_entropy_with_logits

__all__ = ["Generator", "Discriminator", "GANTrainStep"]


def _kw(device, seed: int) -> dict:
    dev = resolve_device(device)
    return dict(device=dev,
                generator=torch.Generator(device=dev).manual_seed(int(seed)))


class Generator(Layer):
    """z [B, z_dim] -> image [B, 1, 28, 28] in (-1, 1)."""

    def __init__(self, z_dim: int = 64, base: int = 32, device=None,
                 seed: int = 0) -> None:
        super().__init__()
        kw = _kw(device, seed)
        self.fc = Linear(z_dim, base * 2 * 7 * 7, **kw)
        self.bn0 = BatchNorm1D(base * 2 * 7 * 7, device=kw["device"])
        self.deconv1 = Conv2DTranspose(base * 2, base, 4, stride=2,
                                       padding=1, **kw)
        self.bn1 = BatchNorm2D(base, device=kw["device"])
        self.deconv2 = Conv2DTranspose(base, 1, 4, stride=2, padding=1,
                                       **kw)
        self.base = base

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn0(self.fc(z)))
        h = h.reshape(z.shape[0], self.base * 2, 7, 7)
        h = torch.relu(self.bn1(self.deconv1(h)))
        return torch.tanh(self.deconv2(h))


class Discriminator(Layer):
    """image [B, 1, 28, 28] -> real/fake logit [B, 1]."""

    def __init__(self, base: int = 32, device=None, seed: int = 0) -> None:
        super().__init__()
        kw = _kw(device, seed)
        self.conv1 = Conv2D(1, base, 4, stride=2, padding=1, **kw)
        self.conv2 = Conv2D(base, base * 2, 4, stride=2, padding=1, **kw)
        self.bn2 = BatchNorm2D(base * 2, device=kw["device"])
        self.fc = Linear(base * 2 * 7 * 7, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.conv1(x), 0.2)
        h = leaky_relu(self.bn2(self.conv2(h)), 0.2)
        return self.fc(h.reshape(x.shape[0], -1))


def _bce_logits(logit: torch.Tensor, target: float) -> torch.Tensor:
    return binary_cross_entropy_with_logits(
        logit, torch.full_like(logit, target), reduction="mean")


class GANTrainStep:
    """One discriminator step, then one generator step, a call (see the
    module note); the parameters, statistics and optimizer states are
    updated in place. ``g_opt``/``d_opt`` are the port's optimizers."""

    def __init__(self, generator: Generator, disc: Discriminator, g_opt,
                 d_opt, seed: int = 0) -> None:
        self.g = generator
        self.d = disc
        self.g_opt = g_opt
        self.d_opt = d_opt
        self._g_params = dict(generator.named_parameters())
        self._d_params = dict(disc.named_parameters())
        self.state = {"g_opt": g_opt.init(self._g_params),
                      "d_opt": d_opt.init(self._d_params)}
        dev = self.g.fc.weight.device
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))

    def _z(self, n: int, gen: torch.Generator) -> torch.Tensor:
        w = self.g.fc.weight
        return torch.randn((n, w.shape[0]), generator=gen, device=w.device,
                           dtype=w.dtype)

    def __call__(self, real: torch.Tensor) -> dict:
        z = self._z(real.shape[0], self.generator)
        with torch.no_grad(), frozen_statistics():
            fake = self.g(z)
        d_loss = _bce_logits(self.d(real), 1.0) \
            + _bce_logits(self.d(fake), 0.0)
        names = list(self._d_params)
        grads = torch.autograd.grad(d_loss, [self._d_params[n]
                                             for n in names])
        self.d_opt.apply_gradients(self._d_params, dict(zip(names, grads)),
                                   self.state["d_opt"])
        fake = self.g(z)
        with frozen_statistics():
            g_loss = _bce_logits(self.d(fake), 1.0)
        names = list(self._g_params)
        grads = torch.autograd.grad(g_loss, [self._g_params[n]
                                             for n in names])
        self.g_opt.apply_gradients(self._g_params, dict(zip(names, grads)),
                                   self.state["g_opt"])
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    def sample(self, n: int, key: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """``n`` images from ``z`` drawn from ``key`` (a generator or an
        int seed; the ``random`` stream without one); no statistics
        written."""
        from ..ops.random_ops import draw_with
        w = self.g.fc.weight
        z = draw_with(key, w.device, lambda g: self._z(n, g))
        with torch.no_grad(), frozen_statistics():
            return self.g(z)
