"""``fluid.dygraph`` migration surface (ref:
python/paddle/fluid/dygraph/__init__.py).

Eager execution is the default, so the graph/dygraph switch collapses:
``guard()`` is a no-op context, ``to_variable`` makes a tensor (on the
card unless ``set_device('cpu')``), and the dygraph layer classes are
the ``nn`` layers.
"""

from __future__ import annotations

import contextlib

from ..autograd import grad, no_grad  # noqa: F401
from ..io import load_dygraph, save_dygraph  # noqa: F401
from ..nn import (GRU, LSTM, RNN, BatchNorm1D, BatchNorm2D,  # noqa: F401
                  BatchNorm3D, Conv2D, Conv3D, Dropout, Embedding,
                  Layer, LayerList, Linear, Parameter, ParameterList,
                  Sequential)

BatchNorm = BatchNorm2D  # fluid.dygraph.BatchNorm's common case


class Pool2D(Layer):
    """(ref: dygraph/nn.py Pool2D) the functional pools with the fluid
    constructor spellings."""

    def __init__(self, pool_size=-1, pool_type: str = "max",
                 pool_stride=1, pool_padding=0,
                 global_pooling: bool = False, ceil_mode: bool = False,
                 exclusive: bool = True, data_format: str = "NCHW"):
        super().__init__()
        if pool_type not in ("max", "avg"):
            raise ValueError(f"pool_type must be max/avg, got {pool_type!r}")
        self._kw = dict(pool_size=pool_size, pool_type=pool_type,
                        pool_stride=pool_stride,
                        pool_padding=pool_padding,
                        global_pooling=global_pooling,
                        ceil_mode=ceil_mode, exclusive=exclusive,
                        data_format=data_format)

    def forward(self, x):
        from ..ops.nn_functional import pool2d
        return pool2d(x, **self._kw)


@contextlib.contextmanager
def guard(place=None):
    """(ref: dygraph/base.py guard) eager is always on; kept so ``with
    fluid.dygraph.guard():`` blocks port unchanged."""
    yield


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """(ref: dygraph/base.py to_variable)."""
    from ..tensor import to_tensor
    return to_tensor(value, dtype=dtype)


def enabled() -> bool:
    return True
