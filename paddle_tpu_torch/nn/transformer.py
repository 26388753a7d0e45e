"""Transformer encoder layers.

Counterparts of ``paddle_tpu.nn.layers.transformer``:
``MultiHeadAttention`` (self-attention; separate q/k/v projections, or
one concatenated ``[d, 3d]`` product under ``fused_qkv_projection``),
the post-norm ``TransformerEncoderLayer`` (its norms use the LayerNorm
default eps 1e-5) and ``TransformerEncoder``. Attention goes through
``kernels.maybe_flash_attention`` in the projections' native
``[B, T, H, D]`` layout, the JAX package's default
(``attention_bthd_layout``). The port has no ``[B, H, T, D]`` route and
no such flag: its flash kernels read heads through strides, so a
transpose would only add two copies around the same kernels. Parameter
names match the JAX layers', so a JAX ``param_dict()`` loads by name.
Not ported yet: cross-attention, ``need_weights``, pre-norm layers and
per-layer rematerialisation (``transformer_remat``). ``device`` None
means ``cuda`` (raises without a GPU).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..core.place import resolve_device
from ..flags import GLOBAL_FLAGS
from . import functional as F
# a module reference: kernels imports nn.functional (see nn/layers.py)
from .. import kernels
from .layers import Dropout, LayerNorm, Linear

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]

_ACTIVATIONS = {"gelu": F.gelu, "relu": torch.relu}


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("embed_dim must divide num_heads")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        kw = dict(device=resolve_device(device), generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(embed_dim, embed_dim, **kw)
        self.v_proj = Linear(embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = x.shape
        if GLOBAL_FLAGS.get("fused_qkv_projection"):
            w = torch.cat([self.q_proj.weight, self.k_proj.weight,
                           self.v_proj.weight], dim=1)
            bias = torch.cat([self.q_proj.bias, self.k_proj.bias,
                              self.v_proj.bias])
            projs = F.linear(x, w, bias).chunk(3, dim=-1)
        else:
            projs = (self.q_proj(x), self.k_proj(x), self.v_proj(x))
        q, k, v = (p.reshape(b, t, self.num_heads, self.head_dim)
                   for p in projs)
        out = kernels.maybe_flash_attention(
            q, k, v, mask=attn_mask, dropout_p=self.dropout,
            training=self.training, layout="bthd")
        return self.out_proj(out.reshape(b, t, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: ``norm1(x + dropout(attn(x)))``, then
    ``norm2(x + dropout(linear2(dropout(act(linear1(x))))))``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            dropout=attn_dropout if attn_dropout is not None else dropout,
            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(dropout)
        self.activation = _ACTIVATIONS[activation]

    def forward(self, src: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        src = self.norm1(src + self.dropout1(self.self_attn(
            src, attn_mask=src_mask)))
        ffn = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        return self.norm2(src + self.dropout2(ffn))


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer_ctor: Callable[[], nn.Module],
                 num_layers: int) -> None:
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer_ctor()
                                     for _ in range(num_layers)])

    def forward(self, src: torch.Tensor,
                src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            src = layer(src, src_mask=src_mask)
        return src
