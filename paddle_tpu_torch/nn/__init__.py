"""Layers and functional ops of the PyTorch package."""

from . import functional
from .layers import GELU, Embedding, LayerNorm, Linear

__all__ = ["functional", "Linear", "Embedding", "GELU", "LayerNorm"]
