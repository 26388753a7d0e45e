"""The BatchNorm family (the port's first buffers a forward updates) and
the other norm layers.

Counterparts of ``paddle_tpu.nn.layers.norm``'s ``_BatchNormBase``,
``BatchNorm``, ``BatchNorm1D``/``2D``/``3D`` and ``SyncBatchNorm``. The
running statistics are the buffers ``_mean`` (zeros) and ``_variance``
(ones), the names of the JAX ``buffer_dict()``, fp32 (``Layer.to(dtype)``
casts parameters only, so they stay fp32 in a bf16 model, as in JAX);
the scale starts at 1 and the shift at 0 (``weight_attr``/``bias_attr``
False drop them).

In training mode (and without ``use_global_stats=True``) the forward
normalises by the batch's statistics (``ops.nn_functional.batch_norm``)
and writes the new running statistics IN PLACE (``copy_`` under
``no_grad``): the JAX layer rebinds them and its step threads them
through, while a captured step here reads and writes each buffer where
it was captured. ``static.TrainStep`` puts them back on a skipped step.
Inside :func:`frozen_statistics` the forward writes nothing: a
rematerialised block's recompute (``models.resnet``) runs its
BatchNorms a second time, and the statistics must move once a step.

``SyncBatchNorm`` (and any BatchNorm given ``sync_axis``, as
``convert_sync_batchnorm`` sets it) reduces its batch statistics over the
process group of that mesh axis (``parallel.collective``), in this
module's arithmetic (``ops.nn_functional.batch_norm`` with a group: one
all-reduce of the sum and the square norm under
``batch_norm_single_pass``, two of the sum and the centred square sum
without it), the gradient crossing the reduction; the running variance
moves by the biased batch variance, as the JAX ``sync_batch_norm`` moves
it. Without a process group it is the plain BatchNorm. Inside
``parallel.ShardedTrainStep`` a plain BatchNorm normalises over the
GLOBAL batch too (:func:`global_batch`, set by the step around its
forward when the batch is split over more than one rank), because the
JAX step runs it in one program over the whole batch; its running
variance keeps the plain unbiased update, with n the global count.

``InstanceNorm2D`` (``InstanceNorm1D``/``3D`` are the same class, as in
JAX), ``GroupNorm`` and ``LocalResponseNorm`` are the JAX layers over
``ops.nn_functional``. ``SpectralNorm(weight_shape)`` holds the power
iteration's start vectors as the buffers ``weight_u`` ``[h]`` and
``weight_v`` ``[w]`` (standard normal from ``generator``) and returns
``weight / sigma``; as the JAX layer, it never moves them (the JAX
``spectral_norm`` discards the iterated vectors), so every call starts
from the same vectors and a captured step reads them as it reads any
buffer.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

from ..core.place import resolve_device
from ..ops import nn_functional as F
from . import initializer as I
from .layer import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "frozen_statistics", "global_batch",
           "global_batch_group",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "GroupNorm",
           "SpectralNorm", "LocalResponseNorm"]


class _Frozen(threading.local):
    def __init__(self) -> None:
        self.depth = 0


_frozen = _Frozen()


class _Global(threading.local):
    def __init__(self) -> None:
        self.group = None


_global = _Global()


@contextlib.contextmanager
def global_batch(group) -> Iterator[None]:
    """BatchNorm forwards inside (on this thread) reduce their training
    statistics over ``group`` (a process group): the batch is split over
    its ranks (``parallel.ShardedTrainStep``)."""
    prev, _global.group = _global.group, group
    try:
        yield
    finally:
        _global.group = prev


def global_batch_group():
    """The process group ``global_batch`` set on this thread (None
    outside it): the ranks the batch's rows are split over. ``MoELayer``
    counts its capacity and slots over it."""
    return _global.group


@contextlib.contextmanager
def frozen_statistics() -> Iterator[None]:
    """BatchNorm forwards inside (on this thread) leave their running
    statistics as they are."""
    _frozen.depth += 1
    try:
        yield
    finally:
        _frozen.depth -= 1


class _BatchNormBase(Layer):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW",
                 use_global_stats: Optional[bool] = None,
                 sync_axis: Optional[str] = None, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.sync_axis = sync_axis
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else I.make_param(
            weight_attr, I.Constant(1.0), (num_features,), device=device)
        self.bias = None if bias_attr is False else I.make_param(
            bias_attr, I.Constant(0.0), (num_features,), device=device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        training = self.training and self.use_global_stats is not True
        group = None
        if training and self.sync_axis is not None:
            from ..parallel import collective
            group = collective.resolve(self.sync_axis)
        elif training:
            group = _global.group
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training, self.momentum, self.epsilon, self.data_format,
            group=group, biased_running_var=group is not None
            and self.sync_axis is not None)
        if training and not _frozen.depth:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return out


class BatchNorm(_BatchNormBase):
    """Fluid-style BatchNorm."""


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features: int, **kw) -> None:
        kw.setdefault("data_format", "NCL")
        super().__init__(num_features, **kw)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features: int, **kw) -> None:
        kw.setdefault("data_format", "NCDHW")
        super().__init__(num_features, **kw)


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose statistics are reduced over the mesh axis
    ``sync_axis`` (the reference's ``sync_batch_norm_op``)."""

    def __init__(self, num_features: int, sync_axis: str = "dp",
                 **kw) -> None:
        super().__init__(num_features, sync_axis=sync_axis, **kw)

    @classmethod
    def convert_sync_batchnorm(cls, layer, sync_axis: str = "dp"):
        """Sets ``sync_axis`` on every BatchNorm of ``layer`` (itself
        included), in place; returns ``layer``."""
        for sub in layer.modules():
            if isinstance(sub, _BatchNormBase):
                sub.sync_axis = sync_axis
        return layer


def _scale_shift(num: int, weight_attr, bias_attr, device) -> tuple:
    weight = None if weight_attr is False else I.make_param(
        weight_attr, I.Constant(1.0), (num,), device=device)
    bias = None if bias_attr is False else I.make_param(
        bias_attr, I.Constant(0.0), (num,), device=device)
    return weight, bias


class InstanceNorm2D(Layer):
    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, device=None) -> None:
        super().__init__()
        self.weight, self.bias = _scale_shift(
            num_features, weight_attr, bias_attr, resolve_device(device))
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, self.weight, self.bias, self.epsilon)


InstanceNorm1D = InstanceNorm2D
InstanceNorm3D = InstanceNorm2D


class GroupNorm(Layer):
    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 device=None) -> None:
        super().__init__()
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.weight, self.bias = _scale_shift(
            num_channels, weight_attr, bias_attr, resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon)


class SpectralNorm(Layer):
    """``weight / sigma`` by power iteration (see the module note)."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 epsilon: float = 1e-12, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = int(weight_shape[dim])
        w = 1
        for s in weight_shape:
            w *= int(s)
        w //= h
        self.register_buffer("weight_u", torch.randn(
            h, generator=generator, device=device))
        self.register_buffer("weight_v", torch.randn(
            w, generator=generator, device=device))

    def forward(self, weight: torch.Tensor) -> torch.Tensor:
        return F.spectral_norm(weight, self.weight_u, self.weight_v,
                               self.power_iters, self.epsilon, self.dim)


class LocalResponseNorm(Layer):
    def __init__(self, size: int = 5, alpha: float = 1e-4,
                 beta: float = 0.75, k: float = 1.0) -> None:
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)
