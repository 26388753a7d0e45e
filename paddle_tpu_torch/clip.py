"""Gradient clipping.

Counterpart of ``paddle_tpu.clip``: a clip is a callable over a
name-keyed dict of gradient tensors that returns a new dict (the inputs
are not changed). The optimizer calls it on the fp32 gradients before
weight decay. Every scale stays a device tensor: the global norm is
reduced in fp32 on the device and never read on the host, so a clip
costs no host sync. A gradient may be an ``ops.sparse.RowSlices``, as
there: its values join the norms and are clipped or scaled, its rows
kept.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .ops.sparse import RowSlices

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_value_", "clip_grad_norm_"]

Grads = Dict[str, Optional[torch.Tensor]]


def _values(g):
    return g.values if isinstance(g, RowSlices) else g


def _map_values(fn, g):
    """``fn`` applied to a dense gradient, or to a RowSlices' values."""
    if g is None:
        return None
    if isinstance(g, RowSlices):
        return RowSlices(g.rows, fn(g.values), g.dense_rows)
    return fn(g)


class ClipGradBase:
    def __call__(self, grads: Grads) -> Grads:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each entry clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max: float, min: Optional[float] = None) -> None:
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, grads):
        return {n: _map_values(
                    lambda v: torch.clamp(v, self.min, self.max), g)
                for n, g in grads.items()}


class ClipGradByNorm(ClipGradBase):
    """Each tensor scaled to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm: float) -> None:
        self.clip_norm = clip_norm

    def __call__(self, grads):
        def clip_one(g):
            v = _values(g)
            norm = torch.sqrt(torch.sum(v * v))
            scale = torch.where(norm > self.clip_norm,
                                self.clip_norm / torch.clamp_min(norm, 1e-12),
                                torch.ones_like(norm))
            return _map_values(lambda x: x * scale, g)
        return {n: None if g is None else clip_one(g)
                for n, g in grads.items()}


class ClipGradByGlobalNorm(ClipGradBase):
    """Every tensor scaled by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken over all of them in fp32."""

    def __init__(self, clip_norm: float) -> None:
        self.clip_norm = clip_norm

    def __call__(self, grads):
        sq = [torch.sum(_values(g).float() * _values(g).float())
              for g in grads.values() if g is not None]
        if not sq:
            return dict(grads)
        global_norm = torch.sqrt(torch.sum(torch.stack(sq)))
        scale = self.clip_norm / torch.clamp_min(global_norm, self.clip_norm)
        return {n: _map_values(lambda v: v * scale.to(v.dtype), g)
                for n, g in grads.items()}


def clip_grad_value_(grads: Grads, clip_value: float) -> Grads:
    return ClipGradByValue(clip_value)(grads)


def clip_grad_norm_(grads: Grads, max_norm: float) -> Grads:
    return ClipGradByGlobalNorm(max_norm)(grads)
