"""Plain attention.

Counterpart of ``paddle_tpu.ops.attention.scaled_dot_product_attention``:
materialised scores, an optional causal (bottom-right aligned) fill, a
boolean keep mask or an additive mask, softmax, dropout on the
probabilities, and the value product. This is where
``kernels.maybe_flash_attention`` sends what its gate keeps from the
flash kernels (eval, short sequences, masks other than [B, 1, 1, Tk]).
Beside it, ``attention_bthd`` (the same math on ``[B, T, H, D]``
inputs) and ``multihead_matmul`` (the fused ``[C, 3C]`` QKV projection
ahead of ``maybe_flash_attention``), as the JAX module has them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import random as _random

__all__ = ["scaled_dot_product_attention", "attention_bthd",
           "multihead_matmul"]


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 scale: Optional[float] = None,
                                 causal: bool = False,
                                 dropout_p: float = 0.0,
                                 training: bool = False,
                                 return_weights: bool = False):
    """q, k, v ``[B, H, T, D]`` (or any ``[..., T, D]``); ``mask``
    broadcasts to ``[..., Tq, Tk]``: additive if float, a keep mask if
    bool. Dropout (training only) draws from the ``dropout`` stream.
    ``return_weights=True`` also returns the (post-dropout) attention
    probabilities ``[..., Tq, Tk]``, ``MultiHeadAttention``'s
    ``need_weights`` output."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("...qd,...kd->...qk", q, k) * scale
    weights = _attention_weights(logits, mask, causal, dropout_p, training)
    out = torch.einsum("...qk,...kd->...qd", weights, v)
    if return_weights:
        return out, weights
    return out


def _attention_weights(logits: torch.Tensor, mask, causal: bool,
                       dropout_p: float, training: bool) -> torch.Tensor:
    """The post-logits tail both layouts share: the causal fill, the
    mask, softmax and dropout on the probabilities."""
    lowest = torch.finfo(logits.dtype).min
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool,
                          device=logits.device).tril(tk - tq)
        logits = logits.masked_fill(~keep, lowest)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, lowest)
        else:
            logits = logits + mask
    weights = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        keep = _random.draw("dropout", logits.device, lambda gen: torch.rand(
            weights.shape, generator=gen,
            device=weights.device) < (1.0 - dropout_p))
        weights = torch.where(keep, weights / (1.0 - dropout_p),
                              torch.zeros_like(weights))
    return weights


def attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, causal: bool = False,
                   dropout_p: float = 0.0,
                   training: bool = False) -> torch.Tensor:
    """Attention on ``[B, T, H, D]`` inputs without explicit transposes:
    the head axis rides the einsums' batch dims. The math is
    :func:`scaled_dot_product_attention`'s (the post-logits tail is
    shared); ``mask`` broadcasts to ``[B, H, Tq, Tk]``. Returns
    ``[B, T, H, D]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = _attention_weights(logits, mask, causal, dropout_p, training)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def multihead_matmul(x: torch.Tensor, w_qkv: torch.Tensor,
                     b_qkv: torch.Tensor, num_heads: int,
                     mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Fused QKV projection and attention (ref: multihead_matmul_op.cu):
    ``x [B, T, C]``, ``w_qkv [C, 3C]``, ``b_qkv [3C]``; returns ``[B, T,
    C]``. The attention is ``kernels.maybe_flash_attention`` in eval
    mode, so the flash forward kernel runs where that gate admits the
    call (a head dim of 128, or of 64 from 8192 keys, at or above
    ``flash_attention_min_seq``), the plain composition elsewhere."""
    b, t, c = x.shape
    qkv = x @ w_qkv + b_qkv  # [B, T, 3C]
    qkv = qkv.reshape(b, t, 3, num_heads, c // num_heads)
    q, k, v = (qkv[:, :, i].movedim(2, 1) for i in range(3))
    from ..kernels import maybe_flash_attention
    out = maybe_flash_attention(q, k, v, mask=mask, scale=scale)
    return out.movedim(1, 2).reshape(b, t, c)
