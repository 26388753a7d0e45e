"""The operand dtypes the CUDA wrappers take, and the cast around them.

The JAX kernels compute in fp32 whatever their operands' dtype (LayerNorm
reads bf16 as fp32 and writes it back; flash attention and the fused
softmax cross-entropy accumulate in fp32). The port's kernels are fp32
kernels, so each wrapper takes fp32, bf16 or fp16 operands, hands the
kernel fp32 copies of the others, and casts its results back.
"""

from __future__ import annotations

from typing import Optional

import torch

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def check(op: str, **operands: Optional[torch.Tensor]) -> None:
    """Raise TypeError for an operand (None skipped) whose dtype is not
    one of :data:`DTYPES`."""
    for name, t in operands.items():
        if t is not None and t.dtype not in DTYPES:
            raise TypeError(f"{op} takes float32, bfloat16 or float16, "
                            f"got {name} {t.dtype}")


def cast(t: Optional[torch.Tensor],
         dtype: torch.dtype = torch.float32) -> Optional[torch.Tensor]:
    """``t`` in ``dtype`` (fp32 by default); as it is, without a dispatch,
    when it already is or is None (the fp32 path's per-call cost, as a
    decode step runs ~25 LayerNorms)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def wide(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` in the dtype the plain versions compute in: fp32, or fp64
    for an fp64 operand (so a float64 reference run on the CPU stays
    float64 end to end). As :func:`cast` for every other dtype."""
    return t if t is None or t.dtype == torch.float64 else cast(t)
