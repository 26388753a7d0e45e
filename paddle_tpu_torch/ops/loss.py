"""Loss ops.

Counterparts of ``paddle_tpu.ops.loss.softmax_with_cross_entropy`` and
``cross_entropy`` (hard labels). Two places where torch's own loss would
differ from the JAX package:

- ``reduction="mean"`` divides by ALL positions, ignored ones counted as
  0.0 (``torch.nn.functional.cross_entropy(ignore_index=...)`` divides
  by the non-ignored count instead);
- an ``ignore_index`` label (-100) is clamped into range before the
  gather: JAX's ``take_along_axis`` tolerates it, torch's ``gather``
  raises. The clamped pick is discarded by the mask.
"""

from __future__ import annotations

import torch

__all__ = ["softmax_with_cross_entropy", "cross_entropy"]


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               ignore_index: int = -100,
                               axis: int = -1) -> torch.Tensor:
    """Per-position ``logsumexp(logits) - logits[label]`` in fp32 (fp64
    for fp64 logits), with
    the class axis kept as size 1 (Paddle's shape); 0.0 where the label
    is ``ignore_index``. ``label`` has the logits' shape without the
    class axis, or with it at size 1."""
    axis = axis % logits.ndim
    lbl = label.squeeze(axis) if label.ndim == logits.ndim else label
    lbl = lbl.unsqueeze(axis).long()
    lg32 = logits if logits.dtype == torch.float64 else logits.float()
    lse = torch.logsumexp(lg32, dim=axis, keepdim=True)
    safe = lbl.clamp(0, logits.shape[axis] - 1)
    picked = torch.gather(lg32, axis, safe)
    return torch.where(lbl != ignore_index, lse - picked,
                       torch.zeros_like(lse))


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100, reduction: str = "mean",
                  axis: int = -1) -> torch.Tensor:
    """Softmax cross-entropy over logits with hard labels, reduced as
    Paddle reduces it (``"mean"`` over every position)."""
    return _reduce(softmax_with_cross_entropy(input, label, ignore_index,
                                              axis), reduction)
