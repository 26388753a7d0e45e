"""The BatchNorm family: the port's first buffers a forward updates.

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

``SyncBatchNorm`` (statistics reduced over the data-parallel group)
comes with the distributed package (ROADMAP A15): it raises
NotImplementedError.
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
           "SyncBatchNorm", "frozen_statistics"]


class _Frozen(threading.local):
    def __init__(self) -> None:
        self.depth = 0


_frozen = _Frozen()


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
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
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
        out, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training, self.momentum, self.epsilon, self.data_format)
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
    """Statistics reduced over the data-parallel group: not ported yet
    (ROADMAP A15, with the distributed package)."""

    def __init__(self, num_features: int, *args, **kw) -> None:
        raise NotImplementedError(
            "SyncBatchNorm reduces its statistics over the data-parallel "
            "group, which comes with the distributed package (ROADMAP "
            "A15); use BatchNorm2D on one card")

    @classmethod
    def convert_sync_batchnorm(cls, layer, sync_axis: str = "dp"):
        raise NotImplementedError(
            "SyncBatchNorm.convert_sync_batchnorm: SyncBatchNorm comes "
            "with the distributed package (ROADMAP A15)")
