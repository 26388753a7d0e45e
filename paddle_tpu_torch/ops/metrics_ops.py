"""Metric ops: the pure per-batch kernels of ``paddle_tpu_torch.metric``.

Counterpart of ``paddle_tpu.ops.metrics_ops`` (accuracy, AUC buckets,
precision/recall counts, ranking pairs, mean IoU). Each reads and writes
tensors only, on the inputs' device, with no host value, so a captured
step may call them.

Two places where a straight torch translation would differ from the JAX
package:

- ``accuracy``: ``jax.lax.top_k`` breaks ties toward the lower index,
  and ``torch.topk`` promises no order for ties (on the card least of
  all), while tied logits are common (a zero-initialised head, bf16).
  So top-k membership is counted, never sorted: the label is in the top
  k iff ``#(x > x[label]) + #(x == x[label] at a lower index) < k``,
  compared in the total order XLA sorts floats by (``-0.0`` below
  ``+0.0``). That is exact, deterministic and JAX's order;
- scatters whose JAX form drops an out-of-range index (``mode="drop"``)
  send it to a spare bin that is sliced off.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["accuracy", "auc_stats", "auc_from_stats",
           "precision_recall_stats", "positive_negative_pair", "mean_iou"]


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """Integer keys ordered as XLA orders floats (the IEEE total order,
    ``-0.0 < +0.0``): a float's bits with the magnitude bits
    of a negative one flipped. bf16/fp16 go through fp32, exactly;
    integers are their own keys."""
    if not x.is_floating_point():
        return x
    if x.dtype == torch.float64:
        bits = x.view(torch.int64)
        return bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)
    bits = x.float().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def accuracy(input: torch.Tensor, label: torch.Tensor,
             k: int = 1) -> torch.Tensor:
    """Fraction of rows whose top ``k`` (ties toward the lower index)
    holds ``label``; an fp32 0-d tensor. ``label`` is ``[N]`` or
    ``[N, 1]``; a label outside ``[0, C)`` is never in the top k."""
    n_cls = input.shape[-1]
    x = _total_order(input.reshape(-1, n_cls))
    lbl = label.reshape(-1, 1).long()
    valid = (lbl >= 0) & (lbl < n_cls)
    xl = torch.gather(x, 1, lbl.clamp(0, n_cls - 1))
    idx = torch.arange(n_cls, device=x.device)
    ahead = (x > xl).sum(1) + ((x == xl) & (idx < lbl)).sum(1)
    correct = (ahead < k) & valid[:, 0]
    return correct.float().mean()


def auc_stats(pred_pos: torch.Tensor, label: torch.Tensor,
              num_thresholds: int = 2048) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-batch fp32 ``(tp, fp)`` histograms over ``num_thresholds``
    buckets of the positive-class score (clipped into range), for a
    streaming AUC."""
    bucket = (pred_pos * num_thresholds).to(torch.int32).clamp(
        0, num_thresholds - 1).reshape(-1).long()
    pos = (label > 0).to(torch.float32).reshape(-1)
    neg = 1.0 - pos
    tp = torch.zeros(num_thresholds, dtype=torch.float32,
                     device=pred_pos.device).index_add_(0, bucket, pos)
    fp = torch.zeros(num_thresholds, dtype=torch.float32,
                     device=pred_pos.device).index_add_(0, bucket, neg)
    return tp, fp


def auc_from_stats(tp_buckets: torch.Tensor,
                   fp_buckets: torch.Tensor) -> torch.Tensor:
    """Trapezoidal AUC over accumulated buckets, thresholds swept from the
    top bucket down."""
    tp_cum = torch.cumsum(tp_buckets.flip(0), 0)
    fp_cum = torch.cumsum(fp_buckets.flip(0), 0)
    tpr = tp_cum / torch.clamp(tp_cum[-1], min=1.0)
    fpr = fp_cum / torch.clamp(fp_cum[-1], min=1.0)
    zero = tpr.new_zeros(1)
    tpr = torch.cat([zero, tpr])
    fpr = torch.cat([zero, fpr])
    return torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0)


def precision_recall_stats(pred_label: torch.Tensor, label: torch.Tensor,
                           num_classes: int) -> Tuple[torch.Tensor, ...]:
    """Per-batch fp32 ``(true positives, predicted count, true count)``
    per class."""
    pl = pred_label.reshape(-1).long()
    tl = label.reshape(-1).long()
    dev = pl.device

    def counts(idx, vals):
        return torch.zeros(num_classes, dtype=torch.float32,
                           device=dev).index_add_(0, idx, vals)

    ones = torch.ones(pl.shape, dtype=torch.float32, device=dev)
    return (counts(pl, (pl == tl).to(torch.float32)), counts(pl, ones),
            counts(tl, ones))


def positive_negative_pair(score: torch.Tensor, label: torch.Tensor,
                           query_id: torch.Tensor) -> Tuple[torch.Tensor,
                                                            ...]:
    """Ranking pairs per query: over pairs of one query with
    ``label_i > label_j``, the fp32 counts of ``score_i > score_j``
    (positive), ``<`` (negative) and ``==`` (neutral)."""
    s = score.reshape(-1)
    lab = label.reshape(-1)
    q = query_id.reshape(-1)
    valid = (q[:, None] == q[None, :]) & (lab[:, None] > lab[None, :])
    si, sj = s[:, None], s[None, :]
    return tuple((valid & cmp).sum().to(torch.float32)
                 for cmp in (si > sj, si < sj, si == sj))


def _bins(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as bins of an ``n + 1``-bin histogram: a negative index
    within ``[-n, 0)`` counts from the end (numpy's rule), and any other
    out-of-range index goes to the spare bin ``n``."""
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx,
                       torch.full_like(idx, n))


def mean_iou(input: torch.Tensor, label: torch.Tensor,
             num_classes: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Mean intersection-over-union over the classes present in the
    prediction or the label: ``(mean_iou fp32, out_wrong [C] int32,
    out_correct [C] int32)``. Out-of-range class ids are dropped."""
    pred = input.reshape(-1).long()
    lbl = label.reshape(-1).long()
    c = num_classes

    def hist(idx):
        b = _bins(idx, c)
        return torch.zeros(c + 1, dtype=torch.int32,
                           device=b.device).index_add_(
            0, b, torch.ones(b.shape, dtype=torch.int32,
                             device=b.device))[:c]

    out_correct = hist(torch.where(pred == lbl, lbl, torch.full_like(lbl,
                                                                     c)))
    union = hist(pred) + hist(lbl) - out_correct
    present = union > 0
    iou = torch.where(present, out_correct.float()
                      / torch.clamp(union, min=1).float(),
                      torch.zeros((), dtype=torch.float32,
                                  device=union.device))
    miou = iou.sum() / torch.clamp(present.sum(), min=1).float()
    out_wrong = torch.where(present, union - out_correct,
                            torch.zeros_like(union))
    return miou, out_wrong, out_correct
