"""Layers, loss layers and functional ops of the PyTorch package."""

from . import functional, initializer, layer
from .conv import AdaptiveAvgPool2D, AvgPool2D, Conv2D, MaxPool2D
from .layer import (HookRemoveHelper, Layer, LayerList, ParameterList,
                    functional_call)
from .layers import (GELU, Dropout, Embedding, Flatten,
                     FusedLinearCrossEntropy, Identity, LayerNorm, Linear,
                     ReLU, Sequential, Tanh)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, KLDivLoss, L1Loss, MarginRankingLoss,
                   MSELoss, NLLLoss, SmoothL1Loss, TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   SyncBatchNorm)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "layer", "Layer", "LayerList",
           "ParameterList", "HookRemoveHelper", "functional_call",
           "Linear", "Embedding", "Dropout", "GELU",
           "Tanh", "ReLU", "Sequential", "LayerNorm", "Flatten", "Identity",
           "Conv2D", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm",
           "FusedLinearCrossEntropy", "CrossEntropyLoss", "MSELoss",
           "L1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "SmoothL1Loss", "MarginRankingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
