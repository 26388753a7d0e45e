"""Convolution, pooling and BatchNorm: the functional ops of the ResNet
path.

Counterparts of ``paddle_tpu.ops.nn_functional``'s ``conv2d``,
``max_pool2d``, ``avg_pool2d`` (and the ``_pool`` they share),
``adaptive_avg_pool2d`` and ``batch_norm``. The JAX package computes
the convs with ``lax.conv_general_dilated`` and the pools with
``lax.reduce_window``, outside any Pallas kernel; here they are
``torch.nn.functional``'s (cuDNN on the card).

Layouts: activations are NCHW or NHWC at the API, as in JAX. An NHWC
tensor is handed to torch as a ``permute``d view (an NCHW view in the
channels-last memory format, no copy) and the result is permuted back,
so cuDNN runs its channels-last kernels and nothing is transposed; an
NCHW tensor goes as it is.
Weights are OIHW, or HWIO with ``weight_format="HWIO"`` (the JAX
default pairing for NHWC); ``weight_format="OIHW"`` with NHWC
activations is what the conv layers pass.

Padding follows ``lax``: an int, one int per spatial dim, one
``(lo, hi)`` pair per dim flattened (``[top, bottom, left, right]``), or
``"SAME"``/``"VALID"``. An asymmetric padding is applied as an explicit
zero pad (``-inf`` for max pooling) before the op. ``ceil_mode`` adds
``stride - 1`` to each high pad, as the JAX ``_pool`` does, so the
output sizes are ``lax.reduce_window``'s; average pooling divides by the
window's real (unpadded) elements when ``exclusive`` and the padding is
not zero, else by the window's size (always for a named padding, which
also ignores ``ceil_mode``, as there).

``batch_norm`` returns ``(out, new_running_mean, new_running_var)``
and writes nothing, as the JAX op; the layers (``nn.norm``) write the
statistics back in place. Python scalars meet a bf16/fp16 tensor
rounded to its dtype first, as JAX's weakly typed scalars do, so the
statistics' dtypes and roundings follow the JAX composition.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as tF

from ..flags import GLOBAL_FLAGS

__all__ = ["conv2d", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "batch_norm"]

IntOrPair = Union[int, Sequence[int]]
_LOW = (torch.bfloat16, torch.float16)


def _pair(v: IntOrPair, n: int = 2) -> Tuple[int, ...]:
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(a) for a in v)


def _same_pads(size: int, k: int, stride: int, dilation: int = 1
               ) -> Tuple[int, int]:
    """``lax``'s SAME padding of one dim: the output is ceil(size /
    stride), the excess split low-first."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding, sizes, ksize, stride, dilation=(1, 1)):
    """``((lo, hi), ...)`` of each spatial dim for ``padding`` in any of
    ``lax``'s spellings (see the module note)."""
    n = len(sizes)
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return ((0, 0),) * n
        if mode == "SAME":
            return tuple(_same_pads(s, k, st, d) for s, k, st, d in
                         zip(sizes, ksize, stride, dilation))
        raise ValueError(f"bad padding {padding!r}")
    if isinstance(padding, int):
        return ((padding, padding),) * n
    padding = [int(p) for p in padding]
    if len(padding) == n:
        return tuple((p, p) for p in padding)
    if len(padding) == 2 * n:
        return tuple((padding[2 * i], padding[2 * i + 1]) for i in range(n))
    raise ValueError(f"bad padding {padding}")


def _to_nchw(x: torch.Tensor, data_format: str) -> torch.Tensor:
    """An NCHW view of ``x``: a permuted view of NHWC (channels-last
    strides), an NCHW tensor itself."""
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2)
    if data_format != "NCHW":
        raise ValueError(f"data_format must be NCHW or NHWC, got "
                         f"{data_format!r}")
    return x


def _from_nchw(y: torch.Tensor, data_format: str) -> torch.Tensor:
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def _pad_spatial(x: torch.Tensor, pads, value: float = 0.0
                 ) -> torch.Tensor:
    """``x`` (an NCHW view) padded by ``((top, bottom), (left, right))``
    with ``value``."""
    (t, b), (l, r) = pads
    if not (t or b or l or r):
        return x
    return tF.pad(x, (l, r, t, b), value=value)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: IntOrPair = 1,
           padding: Union[str, IntOrPair] = 0, dilation: IntOrPair = 1,
           groups: int = 1, data_format: str = "NCHW",
           weight_format: Optional[str] = None) -> torch.Tensor:
    """2-D convolution (``lax.conv_general_dilated``'s), ``x`` in
    ``data_format``, ``weight`` in ``weight_format`` (default: OIHW for
    NCHW, HWIO for NHWC); see the module note. ``x`` and ``weight`` must
    share a dtype, as ``lax`` requires."""
    if weight_format is None:
        weight_format = "OIHW" if data_format == "NCHW" else "HWIO"
    if weight_format == "HWIO":
        weight = weight.permute(3, 2, 0, 1)
    elif weight_format != "OIHW":
        raise ValueError(f"weight_format must be OIHW or HWIO, got "
                         f"{weight_format!r}")
    stride, dilation = _pair(stride), _pair(dilation)
    xc = _to_nchw(x, data_format)
    pads = _pads(padding, xc.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        xc = _pad_spatial(xc, pads)
        sym = (0, 0)
    out = tF.conv2d(xc, weight, None, stride, sym, dilation, groups)
    out = _from_nchw(out, data_format)
    if bias is not None:
        shape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        out = out + bias.reshape(shape)
    return out


def _pool(x: torch.Tensor, kind: str, ksize: IntOrPair,
          stride: Optional[IntOrPair], padding, ceil_mode: bool,
          exclusive: bool, data_format: str = "NCHW") -> torch.Tensor:
    """Max or average pooling over a window with ``lax.reduce_window``'s
    output sizes (see the module note)."""
    xc = _to_nchw(x, data_format)
    ksize = _pair(ksize)
    stride = _pair(stride if stride is not None else ksize)
    pads = _pads(padding, xc.shape[2:], ksize, stride)
    if isinstance(padding, str):
        # as the JAX _pool: a named padding takes no ceil_mode, and an
        # average over it divides by the window's size
        ceil_mode, exclusive = False, False
    if ceil_mode:
        pads = tuple((lo, hi + s - 1) for (lo, hi), s in zip(pads, stride))
    padded = any(lo or hi for lo, hi in pads)
    if kind == "max":
        fill = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        out = tF.max_pool2d(_pad_spatial(xc, pads, fill), ksize, stride)
        return _from_nchw(out, data_format)
    window = ksize[0] * ksize[1]
    summed = tF.avg_pool2d(_pad_spatial(xc, pads), ksize, stride,
                           divisor_override=1)
    if exclusive and padded:
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = tF.avg_pool2d(_pad_spatial(ones, pads), ksize, stride,
                               divisor_override=1)
        out = summed / torch.clamp(counts, min=1.0)
    else:
        out = summed / float(window)
    return _from_nchw(out, data_format)


def max_pool2d(x: torch.Tensor, kernel_size: IntOrPair,
               stride: Optional[IntOrPair] = None,
               padding: IntOrPair = 0, ceil_mode: bool = False,
               data_format: str = "NCHW") -> torch.Tensor:
    """Max pooling; a padded position is ``-inf``, and a tie passes the
    gradient to the first maximum in window order, as JAX's."""
    return _pool(x, "max", kernel_size, stride, padding, ceil_mode, True,
                 data_format)


def avg_pool2d(x: torch.Tensor, kernel_size: IntOrPair,
               stride: Optional[IntOrPair] = None,
               padding: IntOrPair = 0, ceil_mode: bool = False,
               exclusive: bool = True,
               data_format: str = "NCHW") -> torch.Tensor:
    return _pool(x, "avg", kernel_size, stride, padding, ceil_mode,
                 exclusive, data_format)


def adaptive_avg_pool2d(x: torch.Tensor, output_size: IntOrPair,
                        data_format: str = "NCHW") -> torch.Tensor:
    """The mean over each output bin; bins that do not divide take the
    reference's floor/ceil bounds (``start = floor(i H / out)``, ``end =
    ceil((i + 1) H / out)``), which are torch's too."""
    out = tF.adaptive_avg_pool2d(_to_nchw(x, data_format),
                                 _pair(output_size))
    return _from_nchw(out, data_format)


def _weak(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype when that is bf16/fp16 (a
    JAX weakly typed scalar takes the array's dtype before the op)."""
    if like.dtype in _LOW:
        return float(torch.tensor(value, dtype=like.dtype))
    return value


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, training: bool = False,
               momentum: float = 0.9, epsilon: float = 1e-5,
               data_format: str = "NCHW") -> tuple:
    """``(out, new_running_mean, new_running_var)``; the running
    statistics move as ``new = momentum * old + (1 - momentum) * batch``
    (the opposite of torch's ``momentum``), the variance's with the
    unbiased ``var * n / max(n - 1, 1)``. Training mode normalises by the
    batch statistics, single-pass under ``batch_norm_single_pass`` (see
    the flag: ``E[x^2]`` as the fp32-accumulated square norm over ``n``,
    so no fp32 copy of ``x`` is made or kept); eval mode by the running
    ones. The new statistics carry no
    gradient."""
    if data_format in ("NCHW", "NCL", "NCDHW"):
        dims = (0,) + tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        channels = x.shape[1]
    else:
        dims = tuple(range(x.ndim - 1))
        shape = (1,) * (x.ndim - 1) + (-1,)
        channels = x.shape[-1]
    if training:
        n = x.numel() // channels
        if GLOBAL_FLAGS.get("batch_norm_single_pass"):
            # fp32 accumulation without an fp32 copy of x (autograd keeps
            # x alone): the sum of squares as the square of the norm
            # (a wider x is cast down first, as JAX's astype(float32))
            xs = x if x.dtype in (torch.float32,) + _LOW else x.float()
            mean32 = xs.mean(dims, dtype=torch.float32)
            mean_sq = torch.square(torch.linalg.vector_norm(
                xs, 2, dims, dtype=torch.float32)) / n
            var32 = torch.clamp(mean_sq - mean32 * mean32, min=0.0)
            mean, var = mean32.to(x.dtype), var32.to(x.dtype)
        else:
            # jnp.mean / jnp.var: low precision computes in fp32, the
            # variance about the fp32 mean
            xf = x.float() if x.dtype in _LOW else x
            mean32 = xf.mean(dims)
            centred = xf - mean32.reshape(shape)
            mean = mean32.to(x.dtype)
            var = (centred * centred).mean(dims).to(x.dtype)
        with torch.no_grad():
            m_d, v_d = mean.detach(), var.detach()
            unbiased = v_d * _weak(n, v_d) / _weak(max(n - 1, 1), v_d)
            new_mean = momentum * running_mean \
                + _weak(1 - momentum, m_d) * m_d
            new_var = momentum * running_var \
                + _weak(1 - momentum, unbiased) * unbiased
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + _weak(epsilon, var))
    out = (x - mean.reshape(shape)) * inv.reshape(shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, new_mean, new_var
