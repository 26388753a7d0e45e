"""LayerNorm: the CUDA forward kernel's wrapper, its autograd Function,
and the plain version.

The kernel (``csrc/layer_norm.cu``) replaces the Pallas kernel
``paddle_tpu/kernels/layer_norm.py`` (``_ln_kernel`` via
``layer_norm_pallas``); its source note gives the design. The gradient
is the JAX package's ``_ln_bwd`` in plain PyTorch (the JAX package
computes it with XLA ops, not with a Pallas kernel): statistics
recomputed from x, then the three-term
``dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat))`` with
``dy = g * w``, and ``dw = sum(g * xhat)``, ``db = sum(g)`` over rows.
"""

from __future__ import annotations

import torch

from ..nn import functional as F
from . import _build

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_backward"]

# kernel launches since the last reset (kernels.reset_launch_counts)
launches = 0


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor,
                     epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in plain PyTorch (the kernel's
    oracle, and its stand-in for CPU tensors)."""
    return F.layer_norm(x, weight, bias, epsilon, x.ndim - 1)


def layer_norm_backward(x2: torch.Tensor, weight: torch.Tensor,
                        g2: torch.Tensor, epsilon: float):
    """``_ln_bwd`` of the JAX package on rows ``x2`` ``[rows, cols]``
    with output gradient ``g2``: returns (dx, dw, db)."""
    mean = x2.mean(dim=-1, keepdim=True)
    xc = x2 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    xhat = xc * rstd
    dy = g2 * weight
    db = g2.sum(dim=0)
    dw = (g2 * xhat).sum(dim=0)
    m1 = dy.mean(dim=-1, keepdim=True)
    m2 = (dy * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dy - m1 - xhat * m2), dw, db


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, bias, epsilon):
        ctx.save_for_backward(x2, weight)
        ctx.epsilon = epsilon
        return _forward(x2, weight, bias, epsilon)

    @staticmethod
    def backward(ctx, g2):
        x2, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(x2, weight, g2, ctx.epsilon)
        return dx, dw, db, None


def _forward(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             epsilon: float) -> torch.Tensor:
    global launches
    y = torch.empty_like(x2)
    lib = _build.library("layer_norm")
    code = lib.layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        x2.shape[0], x2.shape[1], float(epsilon),
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check("layer_norm", code, "layer_norm_fwd")
    launches += 1
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim of a CUDA fp32 tensor through the
    hand-written kernel, with ``weight`` and ``bias`` ``[cols]``. Any
    shape; leading dims are flattened to rows. Differentiable in x,
    weight and bias (see the module note)."""
    cols = x.shape[-1]
    if x.device.type != "cuda":
        raise ValueError("layer_norm kernel needs a CUDA tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"layer_norm kernel takes float32, got {x.dtype}")
    for t in (weight, bias):
        if t.shape != (cols,) or t.device != x.device \
                or t.dtype != torch.float32:
            raise TypeError(f"layer_norm weight/bias must be float32 "
                            f"[{cols}] on the input's device")
    x2 = x.reshape(-1, cols).contiguous()
    y = _LayerNorm.apply(x2, weight.contiguous(), bias.contiguous(),
                         float(epsilon))
    return y.reshape(x.shape)
