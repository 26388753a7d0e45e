"""Module-level helpers of the JAX package's ``Layer`` that
``torch.nn.Module`` does not have as such.

``to_dtype(module, dtype)`` is ``paddle_tpu.nn.layer.Layer.to(dtype=)``:
it casts the floating PARAMETERS and leaves buffers alone (``Module.to``
would cast floating buffers too). Each parameter keeps its identity, so
tied weights stay tied and references held elsewhere (a ``TrainStep``'s)
see the new dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.dtype import convert_dtype

__all__ = ["to_dtype"]


def to_dtype(module: nn.Module, dtype) -> nn.Module:
    """Cast every floating parameter of ``module`` to ``dtype`` (a torch
    dtype or a name such as ``"bfloat16"``) in place; returns it."""
    if dtype is None:
        return module
    dt = convert_dtype(dtype)
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point() and p.dtype != dt:
                p.data = p.data.to(dt)
    return module
