"""Layers, loss layers and functional ops of the PyTorch package."""

from . import functional, layer
from .layers import (GELU, Dropout, Embedding, FusedLinearCrossEntropy,
                     LayerNorm, Linear, ReLU, Sequential, Tanh)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, NLLLoss, SmoothL1Loss, TripletMarginLoss)
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["functional", "layer", "Linear", "Embedding", "Dropout", "GELU",
           "Tanh", "ReLU", "Sequential", "LayerNorm",
           "FusedLinearCrossEntropy", "CrossEntropyLoss", "MSELoss",
           "L1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "SmoothL1Loss", "MarginRankingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder"]
