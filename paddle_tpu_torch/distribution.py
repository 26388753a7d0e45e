"""Probability distributions: ``Uniform``, ``Normal``, ``Categorical``,
``MultivariateNormalDiag`` and ``kl_divergence``.

Counterpart of ``paddle_tpu.distribution`` (the reference's
``fluid/layers/distributions.py``). Every method is a differentiable
PyTorch expression, so ``log_prob`` of a reparameterized sample
differentiates into the parameters. Parameters broadcast against each
other; ``sample(shape)`` prepends ``shape``.

A parameter given as a tensor keeps its device; a Python or numpy value
goes on ``device`` (None: the card), as float32. ``sample`` takes
``key=`` as the port's random ops do: a ``torch.Generator`` (on the
parameters' device), or an int that seeds a fresh generator there;
without a key it draws from the ``random`` stream of ``core.random``. The
bits are Philox's, not threefry's: the law and the reproducibility from a
seed match the JAX package, the numbers do not.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .ops._common import device_of
from .ops.random_ops import draw_with

__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag", "kl_divergence"]

_LOG_2PI = float(np.log(2 * np.pi))


def _params(*xs, device=None):
    """The parameters as float32 tensors on one device (see the module
    note)."""
    dev = device_of(*xs, device=device)
    return [x.to(device=dev, dtype=torch.float32)
            if isinstance(x, torch.Tensor) else
            torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in xs]


def _value(value, like: torch.Tensor, dtype=torch.float32):
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=dtype)
    return torch.as_tensor(np.asarray(value), device=like.device).to(dtype)


def _shape(*ts) -> tuple:
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


class Distribution:
    """Abstract base (ref: distributions.py Distribution)."""

    def sample(self, shape: Sequence[int] = (), key=None):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other: "Distribution"):
        return kl_divergence(self, other)

    def probs(self, value):
        return torch.exp(self.log_prob(value))


class Uniform(Distribution):
    """U(low, high). ``sample`` is reparameterized (low + (high - low) u),
    so gradients reach the bounds."""

    def __init__(self, low, high, device=None):
        self.low, self.high = _params(low, high, device=device)

    def sample(self, shape: Sequence[int] = (), key=None):
        shape = tuple(shape) + _shape(self.low, self.high)
        dev = self.low.device
        u = draw_with(key, dev, lambda g: torch.rand(
            shape, generator=g, device=dev))
        return self.low + (self.high - self.low) * u

    def log_prob(self, value):
        value = _value(value, self.low)
        inside = (value >= self.low) & (value < self.high)
        lp = -torch.log(self.high - self.low)
        return torch.where(inside, lp, torch.full_like(lp, -math.inf))

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    """N(loc, scale)."""

    def __init__(self, loc, scale, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)

    def sample(self, shape: Sequence[int] = (), key=None):
        shape = tuple(shape) + _shape(self.loc, self.scale)
        dev = self.loc.device
        eps = draw_with(key, dev, lambda g: torch.randn(
            shape, generator=g, device=dev))
        return self.loc + self.scale * eps

    def log_prob(self, value):
        value = _value(value, self.loc)
        var = self.scale ** 2
        return (-((value - self.loc) ** 2) / (2 * var)
                - torch.log(self.scale) - 0.5 * _LOG_2PI)

    def entropy(self):
        return 0.5 + 0.5 * _LOG_2PI + torch.log(
            self.scale.expand(_shape(self.loc, self.scale)))


class Categorical(Distribution):
    """Categorical over the last axis of ``logits``."""

    def __init__(self, logits, device=None):
        (self.logits,) = _params(logits, device=device)
        self._log_p = torch.log_softmax(self.logits, dim=-1)

    @property
    def probs_param(self):
        return torch.exp(self._log_p)

    def sample(self, shape: Sequence[int] = (), key=None):
        """Gumbel-max over the logits (the law of
        ``jax.random.categorical``), int64 ids."""
        shape = tuple(shape) + tuple(self.logits.shape)
        dev = self.logits.device
        u = draw_with(key, dev, lambda g: torch.rand(
            shape, generator=g, device=dev))
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(self.logits + gumbel, dim=-1)

    def log_prob(self, value):
        value = _value(value, self.logits, torch.int64)
        log_p = self._log_p.expand(tuple(value.shape)
                                   + tuple(self._log_p.shape[-1:])) \
            if value.ndim >= self._log_p.ndim else self._log_p
        return torch.take_along_dim(log_p, value[..., None],
                                    dim=-1)[..., 0]

    def entropy(self):
        p = torch.exp(self._log_p)
        return -torch.sum(p * self._log_p, dim=-1)


class MultivariateNormalDiag(Distribution):
    """N(loc, diag(scale)) with the event dim the last axis (``scale``
    the diagonal standard deviations, shaped as ``loc``)."""

    def __init__(self, loc, scale, device=None):
        self.loc, self.scale = _params(loc, scale, device=device)

    @property
    def _dim(self):
        return self.loc.shape[-1]

    def sample(self, shape: Sequence[int] = (), key=None):
        shape = tuple(shape) + _shape(self.loc, self.scale)
        dev = self.loc.device
        eps = draw_with(key, dev, lambda g: torch.randn(
            shape, generator=g, device=dev))
        return self.loc + self.scale * eps

    def log_prob(self, value):
        value = _value(value, self.loc)
        z = (value - self.loc) / self.scale
        return (-0.5 * torch.sum(z ** 2, dim=-1)
                - torch.sum(torch.log(self.scale), dim=-1)
                - 0.5 * self._dim * _LOG_2PI)

    def entropy(self):
        return (0.5 * self._dim * (1 + _LOG_2PI)
                + torch.sum(torch.log(self.scale.expand(
                    _shape(self.loc, self.scale))), dim=-1))


def kl_divergence(p: Distribution, q: Distribution):
    """KL(p || q) for the JAX package's pairs of families."""
    if isinstance(p, Normal) and isinstance(q, Normal):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    if (isinstance(p, MultivariateNormalDiag)
            and isinstance(q, MultivariateNormalDiag)):
        var_ratio = (p.scale / q.scale) ** 2
        t1 = ((p.loc - q.loc) / q.scale) ** 2
        return 0.5 * torch.sum(var_ratio + t1 - 1 - torch.log(var_ratio),
                               dim=-1)
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        pp = torch.exp(p._log_p)
        return torch.sum(pp * (p._log_p - q._log_p), dim=-1)
    if isinstance(p, Uniform) and isinstance(q, Uniform):
        # supp(p) must lie inside supp(q) for a finite KL
        inside = (q.low <= p.low) & (p.high <= q.high)
        kl = torch.log((q.high - q.low) / (p.high - p.low))
        return torch.where(inside, kl, torch.full_like(kl, math.inf))
    if isinstance(p, Uniform) and isinstance(q, Normal):
        # E_p[log p] - E_p[log q], closed form over [a, b]
        a, b = p.low, p.high
        m2 = (b ** 3 - a ** 3) / (3 * (b - a))  # E[x^2]
        mean = (a + b) / 2
        elogq = (-0.5 * _LOG_2PI - torch.log(q.scale)
                 - (m2 - 2 * q.loc * mean + q.loc ** 2)
                 / (2 * q.scale ** 2))
        return -p.entropy() - elogq
    raise NotImplementedError(
        f"kl_divergence({type(p).__name__}, {type(q).__name__})")
