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

Beside them, the functional ops of the common layers: ``dropout2d``
and ``alpha_dropout`` (drawing from the ``dropout`` stream, as the
port's ``dropout``), ``interpolate`` (``upsample``), ``pad2d`` and
``cosine_similarity``. ``interpolate`` computes ``jax.image.resize``'s
resize, as the JAX op does: nearest takes input index ``floor((i + 0.5)
* in / out)``; the linear modes ("area" among them) and ``bicubic``
(Keys' cubic, a = -0.5) are one ``[in, out]`` weight matrix per resized
dim, on half-pixel centres, the kernel widened by ``in / out`` when
shrinking (antialiasing, in every dim count), each column normalised.
With ``align_corners`` the 1-D and 2-D resizes are linear (bicubic
too) on the grid ``linspace(0, in - 1, out)``, and 3-D ones the
half-pixel resize, as the JAX op has them; nearest ignores
``align_corners``.

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
           "batch_norm", "sync_batch_norm", "dropout2d", "alpha_dropout",
           "interpolate", "upsample", "pad2d", "cosine_similarity"]

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
               data_format: str = "NCHW", group=None,
               biased_running_var: bool = False) -> tuple:
    """``(out, new_running_mean, new_running_var)``; the running
    statistics move as ``new = momentum * old + (1 - momentum) * batch``
    (the opposite of torch's ``momentum``), the variance's with the
    unbiased ``var * n / max(n - 1, 1)`` (the biased ``var`` with
    ``biased_running_var``, as the JAX ``sync_batch_norm`` moves it).
    Training mode normalises by the batch statistics, single-pass under
    ``batch_norm_single_pass`` (see the flag: ``E[x^2]`` as the
    fp32-accumulated square norm over ``n``, so no fp32 copy of ``x`` is
    made or kept); eval mode by the running ones. With ``group`` (a
    process group) the batch is split over its ranks and the statistics
    are the whole batch's: the sums are all-reduced over the group
    (``parallel.collective``, the gradient crossing it; one all-reduce
    single-pass, two otherwise) and ``n`` is the whole batch's count. The
    new statistics carry no gradient."""
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
        if group is not None:
            from ..parallel import collective
            n *= collective.world_size(group)

        def total(t: torch.Tensor) -> torch.Tensor:
            """The sum over the whole batch of this rank's sum ``t``."""
            return t if group is None \
                else collective.all_reduce(t, "sum", group)

        if GLOBAL_FLAGS.get("batch_norm_single_pass"):
            # fp32 accumulation without an fp32 copy of x (autograd keeps
            # x alone): the sum of squares as the square of the norm
            # (a wider x is cast down first, as JAX's astype(float32))
            xs = x if x.dtype in (torch.float32,) + _LOW else x.float()
            sums = total(torch.stack([
                xs.sum(dims, dtype=torch.float32),
                torch.square(torch.linalg.vector_norm(
                    xs, 2, dims, dtype=torch.float32))])) / n
            mean32 = sums[0]
            var32 = torch.clamp(sums[1] - mean32 * mean32, min=0.0)
            mean, var = mean32.to(x.dtype), var32.to(x.dtype)
        else:
            # jnp.mean / jnp.var: low precision computes in fp32, the
            # variance about the fp32 mean
            xf = x.float() if x.dtype in _LOW else x
            mean32 = total(xf.sum(dims)) / n
            centred = xf - mean32.reshape(shape)
            mean = mean32.to(x.dtype)
            var = (total((centred * centred).sum(dims)) / n).to(x.dtype)
        with torch.no_grad():
            m_d, v_d = mean.detach(), var.detach()
            run = v_d if biased_running_var \
                else v_d * _weak(n, v_d) / _weak(max(n - 1, 1), v_d)
            new_mean = momentum * running_mean \
                + _weak(1 - momentum, m_d) * m_d
            new_var = momentum * running_var \
                + _weak(1 - momentum, run) * run
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


def sync_batch_norm(x, running_mean, running_var, weight=None, bias=None,
                    training: bool = False, momentum: float = 0.9,
                    epsilon: float = 1e-5, data_format: str = "NCHW",
                    axis_name: Optional[str] = None) -> tuple:
    """The JAX ``sync_batch_norm``: batch statistics reduced over the mesh
    axis ``axis_name``'s process group, with the biased running variance;
    :func:`batch_norm` when not training, without an axis or outside a
    process group."""
    group = None
    if training and axis_name is not None:
        from ..parallel import collective
        group = collective.resolve(axis_name)
    return batch_norm(x, running_mean, running_var, weight, bias, training,
                      momentum, epsilon, data_format, group=group,
                      biased_running_var=group is not None)


def _keep(x: torch.Tensor, p: float, shape) -> torch.Tensor:
    from ..core import random as _random
    return _random.draw("dropout", x.device, lambda gen: torch.rand(
        tuple(shape), generator=gen, device=x.device) < (1.0 - p))


def dropout2d(x: torch.Tensor, p: float = 0.5,
              training: bool = True) -> torch.Tensor:
    """Whole channels dropped (``[N, C, 1, 1]`` keep mask), the kept
    ones scaled by ``1 / (1 - p)``."""
    if not training or p == 0.0:
        return x
    keep = _keep(x, p, x.shape[:2] + (1,) * (x.ndim - 2))
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def alpha_dropout(x: torch.Tensor, p: float = 0.5,
                  training: bool = True) -> torch.Tensor:
    """SELU's dropout: dropped units at SELU's negative saturation, then
    the affine map that keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    keep = _keep(x, p, x.shape)
    return (a * torch.where(keep, x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - x, 0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 at ``x >= 0``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                      out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _resize_weights(n_in: int, n_out: int, kernel,
                    device) -> torch.Tensor:
    """``jax.image.resize``'s ``[n_in, n_out]`` weights (antialiased)."""
    inv = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    w = kernel(torch.abs(sample[None, :] - src[:, None]) / max(inv, 1.0))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """``jax.image.resize`` of the spatial dims (antialiased)."""
    if not x.is_floating_point():
        x = x.float()
    for d, n_out in enumerate(size, start=2):
        n_in = x.shape[d]
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = torch.floor((torch.arange(n_out, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * n_in / n_out).long()
            x = x.index_select(d, idx)
            continue
        w = _resize_weights(n_in, n_out, _triangle if method == "linear"
                            else _keys_cubic, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def _resize_align_corners(x: torch.Tensor, size,
                          method: str) -> torch.Tensor:
    """The JAX op's ``align_corners`` resize: linear on the grid
    ``linspace(0, in - 1, out)`` in 1-D and 2-D, the half-pixel resize
    in 3-D."""
    if len(size) == 3:
        return _resize(x, size, method)
    if len(size) == 1:
        return _resize_align_corners(x[:, :, None, :], (1, size[0]),
                                     method)[:, :, 0, :]
    grids = []
    for n_in, n_out in zip(x.shape[2:], size):
        g = torch.zeros(1, device=x.device) if n_out == 1 else \
            torch.linspace(0.0, n_in - 1, n_out, device=x.device)
        lo = torch.floor(g).long()
        grids.append((lo, torch.clamp_max(lo + 1, n_in - 1), g - lo))
    (h0, h1, fh), (w0, w1, fw) = grids
    fh, fw = fh[None, None, :, None], fw[None, None, None, :]
    tl = x[:, :, h0[:, None], w0[None, :]]
    tr = x[:, :, h0[:, None], w1[None, :]]
    bl = x[:, :, h1[:, None], w0[None, :]]
    br = x[:, :, h1[:, None], w1[None, :]]
    top = tl + (tr - tl) * fw
    bot = bl + (br - bl) * fw
    return top + (bot - top) * fh


def interpolate(x: torch.Tensor, size=None, scale_factor=None,
                mode: str = "nearest", align_corners: bool = False,
                data_format: str = "NCHW") -> torch.Tensor:
    """Resize of the spatial dims of a channel-first ``x`` (see the
    module note)."""
    if data_format not in ("NCHW", "NCDHW", "NCL"):
        raise NotImplementedError("interpolate supports channel-first")
    spatial = x.shape[2:]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    size = tuple(int(s) for s in size)
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}.get(mode)
    if method is None:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    if align_corners and method != "nearest":
        return _resize_align_corners(x, size, method)
    return _resize(x, size, method)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False):
    return interpolate(x, size, scale_factor, mode, align_corners)


def pad2d(x: torch.Tensor, paddings, mode: str = "constant",
          pad_value: float = 0.0, data_format: str = "NCHW") -> torch.Tensor:
    from .manipulation import pad
    return pad(x, paddings, mode=mode, value=pad_value,
               data_format=data_format)


def cosine_similarity(x1: torch.Tensor, x2: torch.Tensor, axis: int = 1,
                      eps: float = 1e-8) -> torch.Tensor:
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)
