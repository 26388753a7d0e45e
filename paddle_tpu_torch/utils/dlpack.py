"""DLPack interop: zero-copy tensor exchange with numpy, JAX, CuPy and
the like through the DLPack protocol.

Counterpart of ``paddle_tpu.utils.dlpack``: the reference's API names
over ``torch.utils.dlpack``.
"""

from __future__ import annotations

import torch
from torch.utils import dlpack as _dl

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """Exports a tensor (or anything ``torch.as_tensor`` takes) as a
    DLPack capsule. A tensor also supports ``__dlpack__``, so a modern
    consumer can take it directly."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return _dl.to_dlpack(t)


def from_dlpack(capsule):
    """Imports a DLPack capsule or any ``__dlpack__``-capable object
    (numpy and JAX arrays included) as a tensor, sharing its memory."""
    return _dl.from_dlpack(capsule)
