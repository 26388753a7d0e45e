"""Device resolution for the PyTorch package.

Entry points run on the GPU unless the caller asks for the CPU: a
``device`` of None means ``cuda``, and asking for ``cuda`` on a host
without a usable card raises instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; ``"cuda[:N]"`` -> that
    card. Raises RuntimeError when a CUDA device is asked for (or
    implied) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev

