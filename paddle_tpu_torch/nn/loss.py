"""Loss layers: ``torch.nn.Module`` wrappers over ``ops.loss``.

Counterparts of ``paddle_tpu.nn.layers.loss`` under its names and
arguments: ``CrossEntropyLoss``, ``MSELoss``, ``L1Loss``, ``NLLLoss``,
``BCELoss``, ``BCEWithLogitsLoss``, ``KLDivLoss``, ``SmoothL1Loss``,
``MarginRankingLoss``, ``CTCLoss``, ``CosineEmbeddingLoss`` and
``TripletMarginLoss`` (``FusedLinearCrossEntropy`` is in
``nn.layers``). The reductions are Paddle's (see ``ops.loss``). A class
``weight`` is kept as the caller gave it (a tensor, not a buffer), as
the JAX layer keeps it.
"""

from __future__ import annotations

from torch import nn

from ..ops import loss as L

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
           "MarginRankingLoss", "CTCLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss"]


class CrossEntropyLoss(nn.Module):
    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean", soft_label: bool = False,
                 axis: int = -1, use_softmax: bool = True) -> None:
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):
        return L.cross_entropy(input, label, self.soft_label,
                               self.ignore_index, self.reduction, self.axis,
                               self.use_softmax, self.weight)


class MSELoss(nn.Module):
    def __init__(self, reduction: str = "mean") -> None:
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return L.mse_loss(input, label, self.reduction)


class L1Loss(nn.Module):
    def __init__(self, reduction: str = "mean") -> None:
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return L.l1_loss(input, label, self.reduction)


class NLLLoss(nn.Module):
    def __init__(self, weight=None, ignore_index: int = -100,
                 reduction: str = "mean") -> None:
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return L.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(nn.Module):
    def __init__(self, weight=None, reduction: str = "mean") -> None:
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):
        return L.bce_loss(input, label, self.weight, self.reduction)


class BCEWithLogitsLoss(nn.Module):
    def __init__(self, weight=None, reduction: str = "mean",
                 pos_weight=None) -> None:
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return L.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.pos_weight, self.reduction)


class KLDivLoss(nn.Module):
    def __init__(self, reduction: str = "mean") -> None:
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return L.kl_div(input, label, self.reduction)


class SmoothL1Loss(nn.Module):
    def __init__(self, reduction: str = "mean", delta: float = 1.0) -> None:
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):
        return L.smooth_l1_loss(input, label, self.delta, self.reduction)


class MarginRankingLoss(nn.Module):
    def __init__(self, margin: float = 0.0,
                 reduction: str = "mean") -> None:
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):
        return L.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(nn.Module):
    """``ops.loss.ctc_loss`` over log-probs ``[T, B, C]``."""

    def __init__(self, blank: int = 0, reduction: str = "mean") -> None:
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths):
        return L.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction)


class CosineEmbeddingLoss(nn.Module):
    def __init__(self, margin: float = 0.0,
                 reduction: str = "mean") -> None:
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return L.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(nn.Module):
    def __init__(self, margin: float = 1.0, p: float = 2.0,
                 reduction: str = "mean") -> None:
        super().__init__()
        self.margin = margin
        self.p = p
        self.reduction = reduction

    def forward(self, anchor, positive, negative):
        return L.triplet_margin_loss(anchor, positive, negative,
                                     self.margin, self.p, self.reduction)
