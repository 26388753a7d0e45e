"""Plain functional ops: ``paddle_tpu.nn.functional``'s counterpart.

Every op of ``ops.nn_functional`` (linear, embedding, layer_norm,
dropout, the convolutions, pools, norms and the vision ops) is
re-exported here, as the JAX module re-exports its namesake, beside
``paddle_tpu.ops.activation``'s ``gelu`` and ``relu``. ``linear``
keeps the reference fc convention: the weight is ``[in, out]``, never
torch's ``[out, in]``, so weights move across from the JAX package
untouched.
"""

from __future__ import annotations

import torch

from ..ops import nn_functional as _nnf
from ..ops.nn_functional import *  # noqa: F401,F403

__all__ = ["gelu", "relu"] + list(_nnf.__all__)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as ``jax.nn.gelu(approximate=False)`` (GPT-2's
    published tanh form is not what the JAX package computes)."""
    return torch.nn.functional.gelu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)
