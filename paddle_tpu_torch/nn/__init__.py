"""Layers and functional ops of the PyTorch package."""

from . import functional
from .layers import GELU, Dropout, Embedding, LayerNorm, Linear, Tanh
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "Linear", "Embedding", "Dropout", "GELU", "Tanh",
           "LayerNorm", "MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder"]
