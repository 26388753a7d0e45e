"""Loss ops.

Counterparts of ``paddle_tpu.ops.loss``, under its names and argument
order: the cross-entropy family (``softmax_with_cross_entropy``,
``cross_entropy`` with ``soft_label``, ``weight``, ``axis`` and
``use_softmax``, ``nll_loss``), the binary ones (``bce_loss``,
``binary_cross_entropy_with_logits``,
``sigmoid_cross_entropy_with_logits``, ``sigmoid_focal_loss``), the
regression ones (``mse_loss``, ``square_error_cost``, ``l1_loss``,
``smooth_l1_loss``, ``huber_loss``, ``modified_huber_loss``), the
margin and ranking ones (``hinge_loss``, ``margin_rank_loss``,
``margin_ranking_loss``, ``rank_loss``, ``bpr_loss``,
``cosine_embedding_loss``, ``triplet_margin_loss``), ``kl_div``,
``log_loss``, ``squared_l2_distance``, ``teacher_student_sigmoid_loss``,
``center_loss`` and ``dice_loss``.

Where torch's own loss would differ from the JAX package:

- ``reduction="mean"`` divides by ALL positions, ignored ones counted as
  0.0 (``torch.nn.functional.cross_entropy(ignore_index=...)`` divides
  by the non-ignored count instead); with a class ``weight`` (and in
  ``nll_loss``) the mean is the weighted sum over the summed weights;
- an ``ignore_index`` label (-100) is clamped into range before a
  gather, and its loss and weight are SELECTED away, never multiplied by
  a zero mask: JAX's out-of-range gather yields NaN there, which its
  ``nll_loss`` and weighted ``cross_entropy`` carry into the result;
  here an ignored position contributes exactly 0 to the loss and to the
  weight sum.

The hard-label cross-entropy reduces in fp32 (fp64 for fp64 logits)
whatever the logits' dtype, as JAX does; the others compute in their
inputs' dtype. Not ported: ``ctc_loss``/``warpctc`` (they come with the
sequence ops).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["softmax_with_cross_entropy", "cross_entropy", "nll_loss",
           "bce_loss", "binary_cross_entropy_with_logits",
           "sigmoid_cross_entropy_with_logits", "sigmoid_focal_loss",
           "mse_loss", "square_error_cost", "l1_loss", "smooth_l1_loss",
           "huber_loss", "modified_huber_loss", "hinge_loss", "kl_div",
           "log_loss", "margin_rank_loss", "margin_ranking_loss",
           "rank_loss", "bpr_loss", "cosine_embedding_loss",
           "triplet_margin_loss", "squared_l2_distance",
           "teacher_student_sigmoid_loss", "center_loss", "dice_loss"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def _hard_label(label: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A hard label with the class axis at size 1 (``label`` has the
    input's shape without that axis, or with it at size 1)."""
    lbl = label.squeeze(axis) if label.ndim == ndim else label
    return lbl.unsqueeze(axis).long()


def _pick(values: torch.Tensor, lbl: torch.Tensor,
          axis: int) -> torch.Tensor:
    """``values`` at ``lbl`` along ``axis``, an out-of-range label
    clamped (its pick is to be selected away)."""
    return torch.gather(values, axis,
                        lbl.clamp(0, values.shape[axis] - 1))


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False,
                               ignore_index: int = -100, axis: int = -1,
                               return_softmax: bool = False):
    """Per-position softmax cross-entropy with the class axis kept at
    size 1 (Paddle's shape). Hard labels: ``logsumexp(logits) -
    logits[label]`` in fp32 (fp64 for fp64 logits), 0.0 where the label
    is ``ignore_index``. ``soft_label``: ``-sum(label * log_softmax)``.
    ``return_softmax`` also returns the softmax."""
    axis = axis % logits.ndim
    if soft_label:
        log_p = torch.log_softmax(logits, dim=axis)
        loss = -torch.sum(label * log_p, dim=axis, keepdim=True)
        return (loss, torch.exp(log_p)) if return_softmax else loss
    lbl = _hard_label(label, logits.ndim, axis)
    keep = lbl != ignore_index
    if return_softmax:
        log_p = torch.log_softmax(logits, dim=axis)
        picked = _pick(log_p, lbl, axis)
        return (torch.where(keep, -picked, torch.zeros_like(picked)),
                torch.exp(log_p))
    lg32 = logits if logits.dtype == torch.float64 else logits.float()
    lse = torch.logsumexp(lg32, dim=axis, keepdim=True)
    loss = lse - _pick(lg32, lbl, axis)
    return torch.where(keep, loss, torch.zeros_like(loss))


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  soft_label: bool = False, ignore_index: int = -100,
                  reduction: str = "mean", axis: int = -1,
                  use_softmax: bool = True,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paddle 2.0's ``cross_entropy`` over logits (``use_softmax``) or
    probabilities, hard or soft labels, reduced as Paddle reduces it
    (``"mean"`` over every position; with ``weight`` on hard labels the
    weighted sum over the summed weights of the kept positions)."""
    axis = axis % input.ndim
    if use_softmax:
        loss = softmax_with_cross_entropy(input, label, soft_label,
                                          ignore_index, axis)
    else:
        log_in = torch.log(torch.clamp(input, min=1e-20))
        if soft_label:
            loss = -torch.sum(label * log_in, dim=axis, keepdim=True)
        else:
            lbl = _hard_label(label, input.ndim, axis)
            picked = _pick(log_in, lbl, axis)
            loss = torch.where(lbl != ignore_index, -picked,
                               torch.zeros_like(picked))
    if weight is not None and not soft_label:
        lbl = _hard_label(label, input.ndim, axis)
        w = torch.where(lbl != ignore_index,
                        weight[lbl.clamp(0, weight.shape[0] - 1)],
                        torch.zeros((), dtype=weight.dtype,
                                    device=weight.device))
        loss = loss * w.to(loss.dtype)
        if reduction == "mean":
            return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    return _reduce(loss, reduction)


def nll_loss(log_prob: torch.Tensor, label: torch.Tensor,
             weight: Optional[torch.Tensor] = None,
             ignore_index: int = -100,
             reduction: str = "mean") -> torch.Tensor:
    """Negative log-likelihood over ``log_prob`` ``[..., C]``; ``"mean"``
    is the (weighted) sum over the summed weights of the kept
    positions."""
    lbl = label.long()
    keep = lbl != ignore_index
    picked = _pick(log_prob, lbl[..., None], -1)[..., 0]
    if weight is not None:
        w = weight[lbl.clamp(0, weight.shape[0] - 1)].to(log_prob.dtype)
    else:
        w = torch.ones_like(picked)
    w = torch.where(keep, w, torch.zeros_like(w))
    loss = torch.where(keep, -picked * w, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    return _reduce(loss, reduction)


def bce_loss(input: torch.Tensor, label: torch.Tensor,
             weight: Optional[torch.Tensor] = None,
             reduction: str = "mean") -> torch.Tensor:
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _softplus_neg_abs(x: torch.Tensor) -> torch.Tensor:
    """``log1p(exp(-|x|))``, as the JAX package writes it."""
    return torch.log1p(torch.exp(-torch.abs(x)))


def binary_cross_entropy_with_logits(
        logit: torch.Tensor, label: torch.Tensor,
        weight: Optional[torch.Tensor] = None,
        pos_weight: Optional[torch.Tensor] = None,
        reduction: str = "mean") -> torch.Tensor:
    max_val = torch.clamp(-logit, min=0.0)
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1 - label) * logit + log_w * (_softplus_neg_abs(logit)
                                              + max_val)
    else:
        loss = (1 - label) * logit + max_val + _softplus_neg_abs(logit)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def sigmoid_cross_entropy_with_logits(x: torch.Tensor, label: torch.Tensor,
                                      ignore_index: int = -100,
                                      normalize: bool = False
                                      ) -> torch.Tensor:
    loss = torch.clamp(x, min=0.0) - x * label + _softplus_neg_abs(x)
    mask = (label != ignore_index).to(x.dtype)
    loss = loss * mask
    if normalize:
        loss = loss / torch.clamp(mask.sum(), min=1.0)
    return loss


def sigmoid_focal_loss(logit: torch.Tensor, label: torch.Tensor,
                       normalizer=None, alpha: float = 0.25,
                       gamma: float = 2.0,
                       reduction: str = "sum") -> torch.Tensor:
    p = torch.sigmoid(logit)
    ce = torch.clamp(logit, min=0.0) - logit * label \
        + _softplus_neg_abs(logit)
    p_t = p * label + (1 - p) * (1 - label)
    alpha_t = alpha * label + (1 - alpha) * (1 - label)
    loss = alpha_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def mse_loss(input: torch.Tensor, label: torch.Tensor,
             reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input: torch.Tensor,
                      label: torch.Tensor) -> torch.Tensor:
    return torch.square(input - label)


def l1_loss(input: torch.Tensor, label: torch.Tensor,
            reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input: torch.Tensor, label: torch.Tensor,
                   delta: float = 1.0,
                   reduction: str = "mean") -> torch.Tensor:
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * torch.square(diff) / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def huber_loss(input: torch.Tensor, label: torch.Tensor,
               delta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(label - input)
    return torch.where(diff <= delta, 0.5 * torch.square(diff),
                       delta * (diff - 0.5 * delta))


def modified_huber_loss(input: torch.Tensor,
                        label: torch.Tensor) -> torch.Tensor:
    """Label in {0, 1} taken as y in {-1, 1}."""
    z = input * (2.0 * label - 1.0)
    return torch.where(z < -1.0, -4.0 * z,
                       torch.where(z < 1.0, torch.square(1.0 - z),
                                   torch.zeros_like(z)))


def hinge_loss(input: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - input * (2.0 * label - 1.0), min=0.0)


def kl_div(input: torch.Tensor, label: torch.Tensor,
           reduction: str = "mean") -> torch.Tensor:
    """``input`` is log-probabilities; ``"batchmean"`` divides the sum by
    the batch size."""
    loss = label * (torch.log(torch.clamp(label, min=1e-20)) - input)
    loss = torch.where(label > 0, loss, torch.zeros_like(loss))
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def log_loss(input: torch.Tensor, label: torch.Tensor,
             epsilon: float = 1e-4) -> torch.Tensor:
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def margin_rank_loss(label: torch.Tensor, left: torch.Tensor,
                     right: torch.Tensor,
                     margin: float = 0.1) -> torch.Tensor:
    return torch.clamp(-label * (left - right) + margin, min=0.0)


def margin_ranking_loss(input: torch.Tensor, other: torch.Tensor,
                        label: torch.Tensor, margin: float = 0.0,
                        reduction: str = "mean") -> torch.Tensor:
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def rank_loss(label: torch.Tensor, left: torch.Tensor,
              right: torch.Tensor) -> torch.Tensor:
    diff = left - right
    return torch.log1p(torch.exp(diff)) - label * diff


def bpr_loss(input: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Bayesian personalised ranking over ``input`` ``[N, C]``: the mean
    over the other classes of ``-log(sigmoid(x[label] - x))``."""
    n, c = input.shape
    lbl = label.reshape(-1, 1).long()
    diff = input - torch.gather(input, 1, lbl)
    loss = -torch.log(torch.clamp(torch.sigmoid(-diff), min=1e-8))
    mask = torch.ones((n, c), dtype=input.dtype,
                      device=input.device).scatter_(1, lbl, 0.0)
    return torch.sum(loss * mask, dim=1, keepdim=True) / (c - 1)


def cosine_embedding_loss(input1: torch.Tensor, input2: torch.Tensor,
                          label: torch.Tensor, margin: float = 0.0,
                          reduction: str = "mean") -> torch.Tensor:
    cos = torch.sum(input1 * input2, dim=-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label > 0, 1.0 - cos,
                       torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0,
                        p: float = 2.0,
                        reduction: str = "mean") -> torch.Tensor:
    def dist(a, b):
        return torch.pow(torch.sum(torch.pow(torch.abs(a - b), p), dim=-1),
                         1 / p)

    return _reduce(torch.clamp(dist(anchor, positive)
                               - dist(anchor, negative) + margin, min=0.0),
                   reduction)


def squared_l2_distance(x: torch.Tensor, y: torch.Tensor) -> tuple:
    """``(sum((x - y)^2, -1), x - y)``."""
    d = x - y
    return torch.sum(torch.square(d), dim=-1), d


def teacher_student_sigmoid_loss(x: torch.Tensor, label: torch.Tensor,
                                 soft_max_up_bound: float = 15.0,
                                 soft_max_lower_bound: float = -15.0
                                 ) -> torch.Tensor:
    z = torch.clamp(x, soft_max_lower_bound, soft_max_up_bound)
    zero = torch.zeros_like(label)
    teacher = torch.where(label > 0.0, label, zero)
    soft_z = torch.log1p(torch.exp(z))
    student = soft_z - z * torch.where(label > 0, torch.ones_like(label),
                                       zero)
    return student + (soft_z - z * teacher)


def center_loss(features: torch.Tensor, label: torch.Tensor,
                centers: torch.Tensor, alpha: float = 0.5,
                update_centers: bool = True) -> tuple:
    """``(0.5 * |f - centers[label]|^2 per row [N, 1], new centers)``;
    each center moves toward its rows by ``alpha`` over ``count + 1``."""
    lbl = label.reshape(-1).long()
    diff = features - centers[lbl]
    loss = 0.5 * torch.sum(torch.square(diff), dim=1, keepdim=True)
    if not update_centers:
        return loss, centers
    counts = torch.zeros(centers.shape[0], dtype=features.dtype,
                         device=features.device).index_add_(
        0, lbl, torch.ones(lbl.shape, dtype=features.dtype,
                           device=features.device))
    grad = torch.zeros_like(centers).index_add_(0, lbl, -diff)
    return loss, centers - alpha * grad / (counts[:, None] + 1.0)


def dice_loss(input: torch.Tensor, label: torch.Tensor,
              epsilon: float = 1e-5) -> torch.Tensor:
    """``1 - Dice`` between probabilities ``[..., D]`` and one-hot class
    ids ``[..., 1]``, averaged over the batch."""
    one_hot = torch.nn.functional.one_hot(
        label.squeeze(-1).long(), input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.ndim))
    inter = torch.sum(input * one_hot, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(one_hot, dim=dims)
    dice = (2.0 * inter + epsilon) / (union + epsilon)
    return torch.mean(1.0 - dice)
