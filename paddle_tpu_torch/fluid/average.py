"""``fluid.average`` (ref: python/paddle/fluid/average.py)."""

from __future__ import annotations

import numpy as np


class WeightedAverage:
    """(ref: average.py WeightedAverage) the numerator keeps the VALUE's
    shape, so array inputs average elementwise and ``eval()`` returns an
    array of that shape. A tensor value is read on the host."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._total = None
        self._weight = 0.0

    def add(self, value, weight=1) -> None:
        if hasattr(value, "detach"):
            value = value.detach().cpu().numpy()
        v = np.asarray(value, np.float64) * float(weight)
        self._total = v if self._total is None else self._total + v
        self._weight += float(weight)

    def eval(self):
        if self._weight == 0 or self._total is None:
            raise ValueError("WeightedAverage.eval() before any add()")
        return self._total / self._weight
