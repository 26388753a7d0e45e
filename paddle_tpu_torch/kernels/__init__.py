"""Hand-written CUDA kernels for the hot ops, and their routing.

Counterpart of ``paddle_tpu.kernels``. Each ``maybe_*`` entry routes by
the tensor's device: a CPU tensor goes to the kernel's plain PyTorch
version, a CUDA tensor to the kernel, which launches or raises. There is
no silent fallback from the kernel to the plain version, and no shape
gate: the TPU kernels' tiling limits (layer norm's cols % 128 and
rows >= 8) do not apply to these kernels.

Each kernel counts its launches; ``launch_counts()`` reads the counts
and ``reset_launch_counts()`` sets them to 0, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..nn import functional as F
from . import layer_norm as _ln
from . import paged_attention as _pa

__all__ = ["maybe_layer_norm", "maybe_paged_attention",
           "maybe_paged_attention_multiquery", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {"layer_norm": _ln.launches,
            "paged_attention": _pa.launches,
            "paged_attention_multiquery": _pa.mq_launches}


def reset_launch_counts() -> None:
    _ln.launches = 0
    _pa.launches = 0
    _pa.mq_launches = 0


def maybe_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, epsilon: float,
                     begin_norm_axis: int) -> torch.Tensor:
    """Affine LayerNorm over dims ``[begin_norm_axis:)``."""
    if x.device.type == "cpu":
        return F.layer_norm(x, weight, bias, epsilon, begin_norm_axis)
    # the kernel normalises the last dim: trailing normalised dims merge
    # into one (a no-op for the usual single normalised dim)
    return _ln.layer_norm(x.flatten(begin_norm_axis), weight.reshape(-1),
                          bias.reshape(-1), epsilon).reshape(x.shape)


def maybe_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Ragged single-query paged decode attention (q [B, H, D], pools
    [N, block_size, H, D]; see kernels/paged_attention.py)."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pool, v_pool, block_tables,
                                         context_lens, scale)
    return _pa.paged_attention(q, k_pool, v_pool, block_tables,
                               context_lens, scale)


def maybe_paged_attention_multiquery(q, q_lens, k_pool, v_pool,
                                     block_tables, context_lens,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Ragged multi-query paged attention for the speculative verify
    step (q [B, Qmax, H, D] plus per-sequence q_lens)."""
    if q.device.type == "cpu":
        return _pa.paged_attention_multiquery_plain(
            q, q_lens, k_pool, v_pool, block_tables, context_lens, scale)
    return _pa.paged_attention_multiquery(q, q_lens, k_pool, v_pool,
                                          block_tables, context_lens, scale)
