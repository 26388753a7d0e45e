"""Layers and functional ops of the PyTorch package."""

from . import functional, layer
from .layers import (GELU, Dropout, Embedding, FusedLinearCrossEntropy,
                     LayerNorm, Linear, Tanh)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "layer", "Linear", "Embedding", "Dropout", "GELU",
           "Tanh", "LayerNorm", "FusedLinearCrossEntropy", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder"]
