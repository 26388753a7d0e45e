"""Layers, loss layers and functional ops of the PyTorch package."""

from . import decode, functional, initializer, layer, rnn
from .conv import AdaptiveAvgPool2D, AvgPool2D, Conv2D, MaxPool2D
from .decode import (BasicDecoder, BeamSearchDecoder, DecodeHelper,
                     Decoder, GreedyEmbeddingHelper, SampleEmbeddingHelper,
                     TrainingHelper, dynamic_decode)
from .layer import (HookRemoveHelper, Layer, LayerList, ParameterList,
                    functional_call)
from .layers import (CELU, ELU, GELU, GLU, SELU, AlphaDropout, Bilinear,
                     CosineSimilarity, Dropout, Dropout2D, Embedding,
                     Flatten, FusedLinearCrossEntropy, Hardshrink,
                     Hardsigmoid, Hardswish, Hardtanh, Identity, LayerNorm,
                     LeakyReLU, Linear, LogSigmoid, LogSoftmax, Maxout,
                     Mish, Pad2D, PReLU, ReLU, ReLU6, Sequential, Sigmoid,
                     Silu, Softmax, Softplus, Softshrink, Softsign, Swish,
                     Tanh, Tanhshrink, ThresholdedReLU, Upsample)
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, KLDivLoss, L1Loss,
                   MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .rnn import (GRU, LSTM, RNN, GRUCell, LSTMCell, RNNCell, SimpleRNN,
                  SimpleRNNCell)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   SyncBatchNorm)
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "layer", "decode", "rnn", "Layer",
           "LayerList", "ParameterList", "HookRemoveHelper",
           "functional_call", "Linear", "Embedding", "Dropout", "GELU",
           "Tanh", "ReLU", "Sequential", "LayerNorm", "Flatten", "Identity",
           "Dropout2D", "AlphaDropout", "Upsample", "Pad2D",
           "CosineSimilarity", "Bilinear", "PReLU", "Maxout", "ReLU6",
           "LeakyReLU", "ELU", "SELU", "CELU", "Sigmoid", "LogSigmoid",
           "Hardsigmoid", "Hardswish", "Hardshrink", "Softshrink",
           "Hardtanh", "Tanhshrink", "Softplus", "Softsign", "Swish", "Silu",
           "Mish", "ThresholdedReLU", "LogSoftmax", "Softmax", "GLU",
           "RNNCell", "LSTMCell", "GRUCell", "SimpleRNNCell", "RNN", "LSTM",
           "GRU", "SimpleRNN", "DecodeHelper", "TrainingHelper",
           "GreedyEmbeddingHelper", "SampleEmbeddingHelper", "Decoder",
           "BasicDecoder", "BeamSearchDecoder", "dynamic_decode", "CTCLoss",
           "Conv2D", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm",
           "FusedLinearCrossEntropy", "CrossEntropyLoss", "MSELoss",
           "L1Loss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "SmoothL1Loss", "MarginRankingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "MultiHeadAttention",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]
