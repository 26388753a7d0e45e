"""Streaming metrics: ``Metric``, ``Accuracy``, ``Precision``, ``Recall``,
``Auc`` and ``accuracy``.

Counterpart of ``paddle_tpu.metric``. The per-batch compute is
``ops.metrics_ops`` (tensors in, tensors out, on the inputs' device);
the accumulation is host-side numpy state, as in the JAX package, so
``update`` reads its inputs to the host. ``Accuracy.compute`` is the
device half that ``hapi.Model.evaluate`` defers: it returns tensors,
and ``update`` then takes them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import metrics_ops as M

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _numpy(x) -> np.ndarray:
    """A tensor (any device; bf16/fp16 as fp32) or array-like as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _tensor(x) -> torch.Tensor:
    """A tensor as it is; an array-like as a CPU tensor (fp64 as fp32,
    as the JAX package takes a numpy array in with x64 off)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


class Metric:
    def reset(self) -> None:
        raise NotImplementedError

    def update(self, *args) -> None:
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__.lower()


class Accuracy(Metric):
    """Top-k accuracy for each k of ``topk``. Each ``update`` counts one:
    the result is the mean of the batch means (the JAX package's rule),
    not a mean over samples."""

    def __init__(self, topk=(1,)) -> None:
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.reset()

    def reset(self) -> None:
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label):
        return [M.accuracy(_tensor(pred), _tensor(label), k)
                for k in self.topk]

    def update(self, correct) -> None:
        batch = 1
        for i, c in enumerate(correct if isinstance(correct, (list, tuple))
                              else [correct]):
            self.total[i] += float(c)
            self.count[i] += batch

    def accumulate(self):
        acc = self.total / np.maximum(self.count, 1)
        return acc[0] if len(self.topk) == 1 else list(acc)


class Precision(Metric):
    """Binary precision of ``preds > 0.5`` against 0/1 labels."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels) -> None:
        p = (_numpy(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _numpy(labels).astype(np.int32).reshape(-1)
        self.tp += float(np.sum((p == 1) & (lab == 1)))
        self.fp += float(np.sum((p == 1) & (lab == 0)))

    def accumulate(self) -> float:
        denom = self.tp + self.fp
        return self.tp / denom if denom > 0 else 0.0


class Recall(Metric):
    """Binary recall of ``preds > 0.5`` against 0/1 labels."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels) -> None:
        p = (_numpy(preds) > 0.5).astype(np.int32).reshape(-1)
        lab = _numpy(labels).astype(np.int32).reshape(-1)
        self.tp += float(np.sum((p == 1) & (lab == 1)))
        self.fn += float(np.sum((p == 0) & (lab == 1)))

    def accumulate(self) -> float:
        denom = self.tp + self.fn
        return self.tp / denom if denom > 0 else 0.0


class Auc(Metric):
    """Streaming histogram AUC. A ``[N, 2]`` prediction is read at
    column 1 (the positive class), any other shape flattened."""

    def __init__(self, num_thresholds: int = 2048) -> None:
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self) -> None:
        self.tp_buckets = np.zeros(self.num_thresholds)
        self.fp_buckets = np.zeros(self.num_thresholds)

    def update(self, preds, labels) -> None:
        preds = _tensor(preds)
        pred_pos = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 \
            else preds.reshape(-1)
        tp, fp = M.auc_stats(pred_pos, _tensor(labels).to(pred_pos.device),
                             self.num_thresholds)
        self.tp_buckets += _numpy(tp)
        self.fp_buckets += _numpy(fp)

    def accumulate(self) -> float:
        return float(M.auc_from_stats(
            torch.from_numpy(self.tp_buckets.astype(np.float32)),
            torch.from_numpy(self.fp_buckets.astype(np.float32))))


def accuracy(input, label, k: int = 1):
    return M.accuracy(_tensor(input), _tensor(label), k)
