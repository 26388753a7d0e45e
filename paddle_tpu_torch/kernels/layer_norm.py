"""LayerNorm forward: the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/layer_norm.cu``) replaces the Pallas kernel
``paddle_tpu/kernels/layer_norm.py`` (``_ln_kernel`` via
``layer_norm_pallas``); its source note gives the design. No backward
yet: serving runs without gradients, and the wrapper refuses inputs that
need one.
"""

from __future__ import annotations

import torch

from ..nn import functional as F
from . import _build

__all__ = ["layer_norm", "layer_norm_plain"]

# kernel launches since the last reset (kernels.reset_launch_counts)
launches = 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor,
                     epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in plain PyTorch (the kernel's
    oracle, and its stand-in for CPU tensors)."""
    return F.layer_norm(x, weight, bias, epsilon, x.ndim - 1)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of a CUDA fp32 tensor through the
    hand-written kernel, with ``weight`` and ``bias`` ``[cols]``. Any
    shape; leading dims are flattened to rows."""
    global launches
    cols = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError("layer_norm kernel needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"layer_norm kernel takes float32, got {x.dtype}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise NotImplementedError(
            "layer_norm kernel has no backward yet; run under "
            "torch.no_grad()")
    for t in (weight, bias):
        if t.shape != (cols,) or t.device != x.device \
                or t.dtype != torch.float32:
            raise TypeError(f"layer_norm weight/bias must be float32 "
                            f"[{cols}] on the input's device")
    x2 = x.reshape(-1, cols).contiguous()
    w, b = weight.contiguous(), bias.contiguous()
    y = torch.empty_like(x2)
    lib = _build.library("layer_norm")
    code = lib.layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        x2.shape[0], cols, float(epsilon),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("layer_norm", code, "layer_norm_fwd")
    launches += 1
    return y.reshape(x.shape)
