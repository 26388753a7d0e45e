"""The inference routes of the kernels as PyTorch operators.

``torch.export`` traces a forward on fake tensors, which have no
storage, so it cannot trace through a kernel bound with ``ctypes`` and
raw data pointers. The kernels an eval forward reaches are therefore
also operators of the ``paddle_tpu_torch`` namespace, which an exported
program records by name:

- ``paddle_tpu_torch::layer_norm(x, weight, bias, epsilon,
  begin_norm_axis)``: affine LayerNorm over dims
  ``[begin_norm_axis:)``;
- ``paddle_tpu_torch::flash_attention(q, k, v, kv_bias, causal, scale,
  bthd)``: the flash forward with an optional ``[B, Tk]`` key bias, no
  dropout.

Each has a fake (shape) function for tracing and two implementations:
on CPU tensors the plain version (``nn.functional.layer_norm``,
``flash_attention_plain``), on CUDA tensors the kernel's wrapper
(``layer_norm.layer_norm``, ``flash_attention.flash_attention``), which
launches or raises and counts its launches. The output is in x's (q's)
dtype on every device. The operators have no autograd formula:
``kernels.maybe_layer_norm`` and ``kernels.maybe_flash_attention`` call
them only where no gradient is wanted, so the wrappers' autograd
Functions record nothing there, and training calls the wrappers
directly.

The operators are defined when ``paddle_tpu_torch.kernels`` is imported,
so a process that loads an exported program (``jit.load``) finds them.
They are defined with ``torch.library.Library`` rather than the
``custom_op`` decorator: the same operator, with a fifth of the
decorator's dispatch cost, which a decode step pays 25 times.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn import functional as F
from . import flash_attention as _fa
from . import layer_norm as _ln

__all__ = ["NAMESPACE", "layer_norm", "flash_attention", "wants_grad"]

NAMESPACE = "paddle_tpu_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor bias, "
            "float epsilon, int begin_norm_axis) -> Tensor")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, "
            "Tensor? kv_bias, bool causal, float? scale, bool bthd) "
            "-> Tensor")


def _layer_norm_cpu(x, weight, bias, epsilon, begin_norm_axis):
    # in x's dtype, as the kernel returns it
    return F.layer_norm(x, weight, bias, epsilon,
                        begin_norm_axis).to(x.dtype)


def _layer_norm_cuda(x, weight, bias, epsilon, begin_norm_axis):
    return _ln.layer_norm(
        x.flatten(begin_norm_axis), weight.reshape(-1), bias.reshape(-1),
        epsilon).reshape(x.shape)


def _layer_norm_fake(x, weight, bias, epsilon, begin_norm_axis):
    return x.new_empty(x.shape)


def _flash_cpu(q, k, v, kv_bias, causal, scale, bthd):
    return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_bias=kv_bias,
                                     bthd=bthd).contiguous()


def _flash_cuda(q, k, v, kv_bias, causal, scale, bthd):
    return _fa.flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_bias=kv_bias, bthd=bthd).contiguous()


def _flash_fake(q, k, v, kv_bias, causal, scale, bthd):
    return q.new_empty(q.shape)


_LIB.impl("layer_norm", _layer_norm_cpu, "CPU")
_LIB.impl("layer_norm", _layer_norm_cuda, "CUDA")
_LIB.impl("flash_attention", _flash_cpu, "CPU")
_LIB.impl("flash_attention", _flash_cuda, "CUDA")
torch.library.register_fake(f"{NAMESPACE}::layer_norm", _layer_norm_fake,
                            lib=_LIB)
torch.library.register_fake(f"{NAMESPACE}::flash_attention", _flash_fake,
                            lib=_LIB)

layer_norm = torch.ops.paddle_tpu_torch.layer_norm.default
flash_attention = torch.ops.paddle_tpu_torch.flash_attention.default


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd would record a call on ``tensors``: grad mode
    on and one of them requiring a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
