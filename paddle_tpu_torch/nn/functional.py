"""Plain functional ops: ``paddle_tpu.nn.functional``'s counterpart.

It re-exports what the JAX module re-exports, in its order: every op of
``ops.activation``, ``ops.attention``'s ``multihead_matmul`` and
``scaled_dot_product_attention``, every op of ``ops.loss`` and of
``ops.nn_functional`` (linear, embedding, layer_norm, dropout, the
convolutions, pools, norms and the vision ops), and ``ops.sequence``'s
``sequence_mask``, ``sequence_pool`` and ``sequence_softmax``. ``linear``
keeps the reference fc convention: the weight is ``[in, out]``, never
torch's ``[out, in]``, so weights move across from the JAX package
untouched. ``gelu`` is the exact (erf) form, as ``jax.nn.gelu(
approximate=False)``.
"""

from __future__ import annotations

from ..ops import activation as _act
from ..ops import loss as _loss
from ..ops import nn_functional as _nnf
from ..ops.activation import *  # noqa: F401,F403
from ..ops.attention import (multihead_matmul,  # noqa: F401
                             scaled_dot_product_attention)
from ..ops.loss import *  # noqa: F401,F403
from ..ops.nn_functional import *  # noqa: F401,F403
from ..ops.sequence import (sequence_mask, sequence_pool,  # noqa: F401
                            sequence_softmax)

__all__ = list(dict.fromkeys(
    list(_act.__all__) + ["multihead_matmul", "scaled_dot_product_attention"]
    + list(_loss.__all__) + list(_nnf.__all__)
    + ["sequence_mask", "sequence_pool", "sequence_softmax"]))
