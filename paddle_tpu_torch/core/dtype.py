"""Dtype names of the PyTorch package.

Counterpart of ``paddle_tpu.core.dtype`` (``convert_dtype``,
``is_floating``): the JAX package's string aliases (``"bfloat16"``,
``"bf16"``, ``"float16"``, ``"fp16"``, ``"half"`` ...), numpy dtypes and
torch dtypes all map to a ``torch.dtype``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

__all__ = ["convert_dtype", "is_floating"]

_ALIASES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "fp16": torch.float16,
    "half": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "double": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def convert_dtype(dtype: Any) -> Optional[torch.dtype]:
    """Any dtype spec (a string alias, a numpy dtype or scalar type, a
    torch dtype) as a ``torch.dtype``; None stays None. Raises ValueError
    for an unknown name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _ALIASES:
            raise ValueError(f"unknown dtype '{dtype}'")
        return _ALIASES[key]
    # numpy dtypes and scalar types (np.float32, np.dtype("int64"), and
    # ml_dtypes' bfloat16, whose name is "bfloat16") go by their name
    return convert_dtype(np.dtype(dtype).name)


def is_floating(dtype: Any) -> bool:
    return convert_dtype(dtype).is_floating_point
