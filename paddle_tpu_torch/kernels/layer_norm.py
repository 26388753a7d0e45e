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

Dtypes, as the JAX kernel: x, weight and bias may be fp32, bf16 or fp16;
they are read as fp32, the statistics and the gradient are fp32, the
output comes back in x's dtype and each gradient in its input's dtype.
The kernel itself runs in fp32: :func:`layer_norm` casts on the way in
and out (the one cast path, which the CPU tests run with the plain
version in the kernel's place).
"""

from __future__ import annotations

import threading

import torch

from ..nn import functional as F
from . import _build
from ._dtypes import cast as _cast, check as _check_dtypes

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_backward"]

# kernel launches since the last reset (kernels.reset_launch_counts),
# counted under a lock: serving threads launch concurrently
launches = 0
_count_lock = threading.Lock()


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor,
                     epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in plain PyTorch (the kernel's
    oracle, and its stand-in for CPU tensors): computed in fp32, returned
    in x's dtype."""
    return F.layer_norm(x.float(), weight.float(), bias.float(), epsilon,
                        x.ndim - 1).to(x.dtype)


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
    """LayerNorm of rows ``x2`` through ``forward`` (the kernel, or a
    plain stand-in taking the same fp32 operands): operands read as fp32,
    the output in x2's dtype; the gradient in fp32, each cast to its
    input's dtype."""

    @staticmethod
    def forward(ctx, x2, weight, bias, epsilon, forward):
        ctx.save_for_backward(x2, weight)
        ctx.epsilon = epsilon
        ctx.bias_dtype = bias.dtype
        return _cast(forward(_cast(x2), _cast(weight), _cast(bias),
                             epsilon), x2.dtype)

    @staticmethod
    def backward(ctx, g2):
        x2, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(_cast(x2), _cast(weight),
                                         _cast(g2), ctx.epsilon)
        return (_cast(dx, x2.dtype), _cast(dw, weight.dtype),
                _cast(db, ctx.bias_dtype), None, None)



def _forward(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             epsilon: float) -> torch.Tensor:
    """The kernel on contiguous fp32 CUDA rows ``x2`` ``[rows, cols]``."""
    global launches
    if x2.device.type != "cuda":
        raise ValueError("layer_norm kernel needs a CUDA tensor")
    y = torch.empty_like(x2)
    lib = _build.library("layer_norm")
    code = lib.layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        x2.shape[0], x2.shape[1], float(epsilon),
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check("layer_norm", code, "layer_norm_fwd")
    with _count_lock:
        launches += 1
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               epsilon: float = 1e-5, forward=_forward) -> torch.Tensor:
    """LayerNorm over the last dim of a CUDA tensor through the
    hand-written kernel, with ``weight`` and ``bias`` ``[cols]``, each
    fp32, bf16 or fp16. Any shape; leading dims are flattened to rows.
    Differentiable in x, weight and bias; the output in x's dtype (see
    the module note). ``forward`` is the fp32 kernel; the CPU tests pass
    :func:`layer_norm_plain` there to run this cast path without a
    card."""
    cols = x.shape[-1]
    _check_dtypes("layer_norm", x=x, weight=weight, bias=bias)
    for t in (weight, bias):
        if t.shape != (cols,) or t.device != x.device:
            raise TypeError(f"layer_norm weight/bias must be [{cols}] on "
                            f"the input's device")
    x2 = x.reshape(-1, cols).contiguous()
    y = _LayerNorm.apply(x2, weight.contiguous(), bias.contiguous(),
                         float(epsilon), forward)
    return y.reshape(x.shape)
