"""The neural-network functional ops.

Counterpart of ``paddle_tpu.ops.nn_functional``: every function of the
JAX module, with its names and results. The JAX package computes the
convs with ``lax.conv_general_dilated`` and the pools with
``lax.reduce_window``, outside any Pallas kernel; here they are
``torch.nn.functional``'s (cuDNN on the card). The 2-D and 3-D pools
share ``_pool``; a transposed convolution is torch's where that computes
the same, else the JAX formulation (``_conv_transpose``); the
``*_with_index`` pools reduce ``(value, flat index)`` pairs with the
first maximum winning a tie, as the JAX pair reduction.

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
           "interpolate", "upsample", "pad2d", "cosine_similarity",
           # the vision slice
           "conv1d", "conv3d", "conv2d_transpose", "depthwise_conv2d",
           "conv_shift", "pool2d", "pool3d", "max_pool3d", "avg_pool3d",
           "adaptive_max_pool2d", "adaptive_pool3d",
           "max_pool2d_with_index", "max_pool3d_with_index", "unpool",
           "instance_norm", "group_norm", "local_response_norm", "lrn",
           "spectral_norm", "data_norm", "affine_channel", "inplace_abn",
           "unfold", "fold", "grid_sample", "affine_grid", "normalize",
           "l2_normalize", "cos_sim", "label_smooth", "one_hot",
           "npair_loss", "random_crop", "add_position_encoding",
           "similarity_focus", "continuous_value_model",
           "deformable_roi_pooling", "dropout_keep_mask",
           # the GPT and BERT paths' (nn.functional's until the vision
           # slice)
           "linear", "fc", "embedding", "lookup_table", "dropout",
           "layer_norm"]

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
    """``x`` (channel-first) padded by one ``(lo, hi)`` pair per spatial
    dim with ``value``; a negative pad crops, as ``lax.pad``'s does."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if not any(flat):
        return x
    return tF.pad(x, flat, value=value)


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
          exclusive: bool, data_format: str = "NCHW", spatial: int = 2,
          global_pool: bool = False) -> torch.Tensor:
    """Max or average pooling over a window with ``lax.reduce_window``'s
    output sizes (see the module note), 2-D (NCHW or NHWC) or 3-D
    (NCDHW); ``global_pool`` makes the window the whole spatial extent."""
    xc = _to_nchw(x, data_format) if spatial == 2 else x
    if global_pool:
        ksize, stride, padding = tuple(xc.shape[2:]), None, 0
    ksize = _pair(ksize, spatial)
    stride = _pair(stride if stride is not None else ksize, spatial)
    pads = _pads(padding, xc.shape[2:], ksize, stride, (1,) * spatial)
    if isinstance(padding, str):
        # as the JAX _pool: a named padding takes no ceil_mode, and an
        # average over it divides by the window's size
        ceil_mode, exclusive = False, False
    if ceil_mode:
        pads = tuple((lo, hi + s - 1) for (lo, hi), s in zip(pads, stride))
    padded = any(lo or hi for lo, hi in pads)
    back = (lambda y: _from_nchw(y, data_format)) if spatial == 2 \
        else (lambda y: y)
    if kind == "max":
        fill = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        pool = tF.max_pool2d if spatial == 2 else tF.max_pool3d
        return back(pool(_pad_spatial(xc, pads, fill), ksize, stride))
    if kind != "avg":
        raise ValueError(f"pool_type must be max or avg, got {kind!r}")
    pool = tF.avg_pool2d if spatial == 2 else tF.avg_pool3d
    window = 1
    for k in ksize:
        window *= k
    summed = pool(_pad_spatial(xc, pads), ksize, stride,
                  divisor_override=1)
    if exclusive and padded:
        ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = pool(_pad_spatial(ones, pads), ksize, stride,
                      divisor_override=1)
        return back(summed / torch.clamp(counts, min=1.0))
    return back(summed / float(window))


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


# ---------------------------------------------------------------------------
# the vision slice: the rest of the JAX module's convolutions, pools,
# norms and misc ops
# ---------------------------------------------------------------------------

def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: IntOrPair = 1,
           padding: Union[str, IntOrPair] = 0, dilation: IntOrPair = 1,
           groups: int = 1, data_format: str = "NCDHW") -> torch.Tensor:
    """3-D convolution: NCDHW with OIDHW weights, or NDHWC with DHWIO
    weights (the JAX pairing)."""
    if data_format == "NDHWC":
        xc, weight = x.permute(0, 4, 1, 2, 3), weight.permute(4, 3, 0, 1, 2)
    elif data_format == "NCDHW":
        xc = x
    else:
        raise ValueError(f"data_format must be NCDHW or NDHWC, got "
                         f"{data_format!r}")
    stride, dilation = _pair(stride, 3), _pair(dilation, 3)
    pads = _pads(padding, xc.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        xc, sym = _pad_spatial(xc, pads), (0, 0, 0)
    out = tF.conv3d(xc, weight, None, stride, sym, dilation, groups)
    if data_format == "NDHWC":
        out = out.permute(0, 2, 3, 4, 1)
    if bias is not None:
        shape = (1, -1, 1, 1, 1) if data_format == "NCDHW" \
            else (1, 1, 1, 1, -1)
        out = out + bias.reshape(shape)
    return out


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: Union[str, int] = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """NCL convolution with ``[out, in / groups, k]`` weights, as a 2-D
    convolution over a height of one (the JAX formulation)."""
    pad = padding if isinstance(padding, str) else [0, padding]
    out = conv2d(x[:, :, None, :], weight[:, :, None, :], bias,
                 stride=[1, stride], padding=pad, dilation=[1, dilation],
                 groups=groups)
    return out[:, :, 0, :]


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     stride: IntOrPair = 1,
                     padding: Union[str, IntOrPair] = 0,
                     dilation: IntOrPair = 1,
                     data_format: str = "NCHW") -> torch.Tensor:
    channels = x.shape[1] if data_format == "NCHW" else x.shape[-1]
    return conv2d(x, weight, bias, stride, padding, dilation,
                  groups=channels, data_format=data_format)


def _transpose_weight(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """``[in, out / groups, *k]`` -> the ``[out, in / groups, *k]`` weight
    of the forward convolution that computes the transpose (flipped
    taps), as the JAX ``conv2d_transpose`` builds it."""
    spatial = tuple(range(2, weight.ndim))
    w = torch.flip(weight, spatial)
    if groups > 1:
        i, og = w.shape[:2]
        w = w.reshape((groups, i // groups, og) + tuple(w.shape[2:]))
        return w.transpose(1, 2).reshape(
            (groups * og, i // groups) + tuple(w.shape[3:]))
    return w.transpose(0, 1)


def _conv_transpose(x: torch.Tensor, weight: torch.Tensor, stride, padding,
                    output_padding, dilation, groups: int) -> torch.Tensor:
    """Channel-first transposed convolution of 2 or 3 spatial dims in the
    JAX formulation: ``x`` dilated by ``stride``, padded by ``(k_eff - 1
    - lo, k_eff - 1 - hi + output_padding)`` (a negative pad crops) and
    convolved with the flipped taps. Where torch's ``conv_transpose``
    computes the same (symmetric padding, ``output_padding`` below the
    stride or the dilation) it runs that."""
    n = weight.ndim - 2
    stride, dilation = _pair(stride, n), _pair(dilation, n)
    opad = _pair(output_padding, n)
    if isinstance(padding, str):
        raise ValueError("string padding unsupported for transpose conv")
    pads = _pads(padding, x.shape[2:], weight.shape[2:], stride, dilation)
    if all(lo == hi >= 0 for lo, hi in pads) and all(
            o < max(s, d) for o, s, d in zip(opad, stride, dilation)):
        fn = tF.conv_transpose2d if n == 2 else tF.conv_transpose3d
        return fn(x, weight, None, stride, tuple(lo for lo, _ in pads),
                  opad, groups, dilation)
    keff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    lhs = [(k - 1 - lo, k - 1 - hi + o)
           for k, (lo, hi), o in zip(keff, pads, opad)]
    if any(s > 1 for s in stride):
        size = [(d - 1) * s + 1 for d, s in zip(x.shape[2:], stride)]
        up = x.new_zeros(tuple(x.shape[:2]) + tuple(size))
        up[(slice(None), slice(None))
           + tuple(slice(None, None, s) for s in stride)] = x
        x = up
    fn = tF.conv2d if n == 2 else tF.conv3d
    return fn(_pad_spatial(x, lhs), _transpose_weight(weight, groups),
              None, 1, 0, dilation, groups)


def conv2d_transpose(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     stride: IntOrPair = 1, padding: IntOrPair = 0,
                     output_padding: IntOrPair = 0,
                     dilation: IntOrPair = 1, groups: int = 1,
                     data_format: str = "NCHW") -> torch.Tensor:
    """Transposed 2-D convolution, weight ``[in, out / groups, kh, kw]``
    (see :func:`_conv_transpose`)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d_transpose: data_format must be NCHW "
                         f"or NHWC, got {data_format!r}")
    out = _from_nchw(_conv_transpose(_to_nchw(x, data_format), weight,
                                     stride, padding, output_padding,
                                     dilation, groups), data_format)
    if bias is not None:
        out = out + (bias.reshape(1, -1, 1, 1) if data_format == "NCHW"
                     else bias.reshape(1, 1, 1, -1))
    return out


def conv_shift(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Circular correlation of each row of ``x`` [b, m] with ``y`` [b,
    n]: ``out[b, i] = sum_j x[b, (i + j - n // 2) % m] y[b, j]``."""
    m, n = x.shape[1], y.shape[1]
    half = n // 2
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]) % m
    return torch.einsum("bmn,bn->bm", x[:, idx], y)


def pool2d(x: torch.Tensor, pool_size: IntOrPair = -1,
           pool_type: str = "max", pool_stride: IntOrPair = 1,
           pool_padding: IntOrPair = 0, global_pooling: bool = False,
           ceil_mode: bool = False, exclusive: bool = True,
           data_format: str = "NCHW") -> torch.Tensor:
    """The legacy ``fluid.layers.pool2d`` signature."""
    return _pool(x, pool_type, pool_size, pool_stride, pool_padding,
                 ceil_mode, exclusive, data_format, 2, global_pooling)


def pool3d(x: torch.Tensor, pool_size=-1, pool_type: str = "max",
           pool_stride=1, pool_padding=0, global_pooling: bool = False,
           ceil_mode: bool = False, exclusive: bool = True) -> torch.Tensor:
    """NCDHW pooling with the legacy signature."""
    return _pool(x, pool_type, pool_size, pool_stride, pool_padding,
                 ceil_mode, exclusive, "NCDHW", 3, global_pooling)


def max_pool3d(x: torch.Tensor, kernel_size: IntOrPair,
               stride: Optional[IntOrPair] = None, padding: IntOrPair = 0,
               ceil_mode: bool = False) -> torch.Tensor:
    return _pool(x, "max", kernel_size, stride, padding, ceil_mode, True,
                 "NCDHW", 3)


def avg_pool3d(x: torch.Tensor, kernel_size: IntOrPair,
               stride: Optional[IntOrPair] = None, padding: IntOrPair = 0,
               ceil_mode: bool = False,
               exclusive: bool = True) -> torch.Tensor:
    return _pool(x, "avg", kernel_size, stride, padding, ceil_mode,
                 exclusive, "NCDHW", 3)


def adaptive_max_pool2d(x: torch.Tensor,
                        output_size: IntOrPair) -> torch.Tensor:
    """NCHW; the reference's floor/ceil bins (torch's)."""
    return tF.adaptive_max_pool2d(x, _pair(output_size))


def adaptive_pool3d(x: torch.Tensor, output_size,
                    pool_type: str = "avg") -> torch.Tensor:
    """NCDHW adaptive pooling over the reference's floor/ceil bins."""
    size = _pair(output_size, 3)
    if pool_type == "avg":
        return tF.adaptive_avg_pool3d(x, size)
    return tF.adaptive_max_pool3d(x, size)


def _max_pool_with_index(x: torch.Tensor, kernel_size, stride, padding,
                         spatial: int) -> tuple:
    """Each window's maximum and its flat index over the input's spatial
    dims (per channel), the first maximum on a tie, as the JAX pair
    reduction; a padded cell is ``(-inf, 2**31 - 1)``."""
    sizes = tuple(x.shape[2:2 + spatial])
    ksize = _pair(kernel_size, spatial)
    strides = _pair(stride if stride is not None else kernel_size, spatial)
    pads = _pads(padding, sizes, ksize, strides, (1,) * spatial)
    n_cells = 1
    for s in sizes:
        n_cells *= s
    idx = torch.arange(n_cells, dtype=torch.int64, device=x.device) \
        .reshape((1, 1) + sizes).expand(x.shape)
    neg = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    v, i = _pad_spatial(x, pads, neg), _pad_spatial(idx, pads, 2 ** 31 - 1)
    for d, (k, s) in enumerate(zip(ksize, strides)):
        v, i = v.unfold(2 + d, k, s), i.unfold(2 + d, k, s)
    v, i = v.flatten(-spatial), i.flatten(-spatial)
    best = v.max(-1, keepdim=True).values
    first = torch.where(v == best, i, torch.full_like(i, 2 ** 31 - 1))
    return best[..., 0], first.min(-1).values


def max_pool2d_with_index(x: torch.Tensor, kernel_size: IntOrPair,
                          stride: Optional[IntOrPair] = None,
                          padding: IntOrPair = 0) -> tuple:
    """``(out, argmax)``: each window's maximum and its flat index over
    the input's H x W (see :func:`_max_pool_with_index`)."""
    return _max_pool_with_index(x, kernel_size, stride, padding, 2)


def max_pool3d_with_index(x: torch.Tensor, kernel_size, stride=None,
                          padding=0) -> tuple:
    """The 3-D ``(out, argmax)``; the index over D x H x W, int32 as the
    JAX function returns it."""
    vals, idx = _max_pool_with_index(x, kernel_size, stride, padding, 3)
    return vals, idx.to(torch.int32)


def unpool(x: torch.Tensor, indices: torch.Tensor, kernel_size: IntOrPair,
           stride: Optional[IntOrPair] = None,
           output_size: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Scatters each pooled value back to its argmax cell (zeros
    elsewhere)."""
    n, c, h, w = x.shape
    ksize = _pair(kernel_size)
    stride = _pair(stride if stride is not None else kernel_size)
    if output_size is None:
        oh = (h - 1) * stride[0] + ksize[0]
        ow = (w - 1) * stride[1] + ksize[1]
    else:
        oh, ow = output_size[-2:]
    out = x.new_zeros((n, c, oh * ow))
    out = out.scatter(2, indices.reshape(n, c, -1).long(),
                      x.reshape(n, c, -1))
    return out.reshape(n, c, oh, ow)


def _norm_over(x: torch.Tensor, dims, epsilon: float) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps)`` over ``dims``, the population
    variance about the mean (``jnp.var``)."""
    mean = x.mean(dims, keepdim=True)
    xc = x - mean
    return xc * torch.rsqrt((xc * xc).mean(dims, keepdim=True) + epsilon)


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  epsilon: float = 1e-5) -> torch.Tensor:
    """Channel-first; statistics per (sample, channel) over the spatial
    dims."""
    out = _norm_over(x, tuple(range(2, x.ndim)), epsilon)
    return _affine(out, weight, bias, (1, -1) + (1,) * (x.ndim - 2))


def group_norm(x: torch.Tensor, groups: int,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, epsilon: float = 1e-5,
               data_format: str = "NCHW") -> torch.Tensor:
    """Statistics per (sample, group of ``C / groups`` channels)."""
    if data_format != "NCHW":
        raise NotImplementedError("group_norm supports NCHW")
    n, c = x.shape[:2]
    g = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    out = _norm_over(g, tuple(range(2, g.ndim)), epsilon).reshape(x.shape)
    return _affine(out, weight, bias, (1, -1) + (1,) * (x.ndim - 2))


def local_response_norm(x: torch.Tensor, size: int = 5,
                        alpha: float = 1e-4, beta: float = 0.75,
                        k: float = 1.0) -> torch.Tensor:
    """NCHW cross-channel LRN: ``x / (k + alpha * sum of x^2 over a
    window of size channels)^beta``, the window from ``c - size // 2``."""
    half = size // 2
    sq = tF.pad(x * x, (0, 0, 0, 0, half, size - 1 - half))
    window = sum(sq[:, i:i + x.shape[1]] for i in range(size))
    return x / torch.pow(k + alpha * window, beta)


lrn = local_response_norm


def data_norm(x: torch.Tensor, batch_size, batch_sum, batch_square_sum,
              epsilon: float = 1e-4) -> torch.Tensor:
    """Normalisation by accumulated batch statistics."""
    mean = batch_sum / batch_size
    scale = torch.rsqrt(batch_square_sum / batch_size - mean * mean
                        + epsilon)
    return (x - mean) * scale


def affine_channel(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   data_format: str = "NCHW") -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.ndim - 2) if data_format == "NCHW" \
        else (1,) * (x.ndim - 1) + (-1,)
    return x * scale.reshape(shape) + bias.reshape(shape)


def spectral_norm(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  power_iters: int = 1, epsilon: float = 1e-12,
                  dim: int = 0) -> torch.Tensor:
    """``weight / sigma``, sigma from ``power_iters`` power iterations
    started at ``u`` and ``v`` (``v = W^T u / (|W^T u| + eps)``, then ``u
    = W v / (|W v| + eps)``), ``W`` the weight with ``dim`` first and the
    rest flattened. As the JAX function, the iterated vectors are not
    returned: the caller's ``u`` and ``v`` stay where they were."""
    w = torch.movedim(weight, dim, 0)
    w_mat = w.reshape(w.shape[0], -1)
    for _ in range(power_iters):
        v = w_mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + epsilon)
        u = w_mat @ v
        u = u / (torch.linalg.vector_norm(u) + epsilon)
    return weight / (u @ w_mat @ v)


def inplace_abn(x: torch.Tensor, running_mean, running_var, weight=None,
                bias=None, training: bool = False, momentum: float = 0.9,
                epsilon: float = 1e-5, act: Optional[str] = None,
                act_alpha: float = 1.0) -> tuple:
    """:func:`batch_norm` then ``act`` (relu, leaky_relu or elu); returns
    ``(out, new_running_mean, new_running_var)``."""
    y, new_mean, new_var = batch_norm(x, running_mean, running_var, weight,
                                      bias, training, momentum, epsilon)
    if act == "relu":
        y = torch.relu(y)
    elif act == "leaky_relu":
        y = tF.leaky_relu(y, act_alpha)
    elif act == "elu":
        y = tF.elu(y, act_alpha)
    elif act is not None:
        raise ValueError(f"inplace_abn: unsupported act {act}")
    return y, new_mean, new_var


def unfold(x: torch.Tensor, kernel_sizes: IntOrPair, strides: IntOrPair = 1,
           paddings: IntOrPair = 0, dilations: IntOrPair = 1
           ) -> torch.Tensor:
    """im2col: NCHW -> ``[N, C * kh * kw, L]``, the taps in ``(c, i, j)``
    order."""
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    n, c = x.shape[:2]
    x = _pad_spatial(x, _pads(paddings, x.shape[2:], (kh, kw), (sh, sw)))
    oh = (x.shape[2] - (dh * (kh - 1) + 1)) // sh + 1
    ow = (x.shape[3] - (dw * (kw - 1) + 1)) // sw + 1
    patches = [x[:, :, i * dh:i * dh + oh * sh:sh, j * dw:j * dw + ow * sw:sw]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, 2).reshape(n, c * kh * kw, oh * ow)


def fold(x: torch.Tensor, output_sizes: IntOrPair, kernel_sizes: IntOrPair,
         strides: IntOrPair = 1, paddings: IntOrPair = 0,
         dilations: IntOrPair = 1) -> torch.Tensor:
    """col2im, the adjoint of :func:`unfold`: overlapping taps add."""
    oh_, ow_ = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    pads = _pads(paddings, (oh_, ow_), (kh, kw), (sh, sw))
    n, ckk = x.shape[:2]
    c = ckk // (kh * kw)
    hp = oh_ + pads[0][0] + pads[0][1]
    wp = ow_ + pads[1][0] + pads[1][1]
    oh = (hp - (dh * (kh - 1) + 1)) // sh + 1
    ow = (wp - (dw * (kw - 1) + 1)) // sw + 1
    cols = x.reshape(n, c, kh * kw, oh, ow)
    out = x.new_zeros((n, c, hp, wp))
    k = 0
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + oh * sh:sh,
                j * dw:j * dw + ow * sw:sw] += cols[:, :, k]
            k += 1
    return out[:, :, pads[0][0]:hp - pads[0][1], pads[1][0]:wp - pads[1][1]]


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros",
                align_corners: bool = True) -> torch.Tensor:
    """NCHW ``x`` sampled at ``grid`` [N, Ho, Wo, 2] ((x, y) in [-1, 1]).
    A corner outside the image reads 0 under ``"zeros"`` and the clamped
    edge otherwise; nearest rounds half to even."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    flat = x.reshape(n, c, h * w)

    def sample(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        at = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, 1, -1)
        vals = flat.gather(2, at.expand(n, c, at.shape[-1])) \
            .reshape((n, c) + tuple(ix.shape[1:]))
        if padding_mode == "zeros":
            vals = vals * valid[:, None].to(x.dtype)
        return vals

    if mode == "nearest":
        return sample(torch.round(fx).long(), torch.round(fy).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    x1, y1 = x0 + 1, y0 + 1
    wa = ((x1 - fx) * (y1 - fy))[:, None]
    wb = ((x1 - fx) * (fy - y0))[:, None]
    wc = ((fx - x0) * (y1 - fy))[:, None]
    wd = ((fx - x0) * (fy - y0))[:, None]
    return (sample(x0, y0) * wa + sample(x0, y1) * wb
            + sample(x1, y0) * wc + sample(x1, y1) * wd).to(x.dtype)


def affine_grid(theta: torch.Tensor, out_shape: Sequence[int],
                align_corners: bool = True) -> torch.Tensor:
    """``theta`` [N, 2, 3] -> the sampling grid [N, H, W, 2] of
    ``out_shape`` (N, C, H, W)."""
    _, _, h, w = out_shape

    def linsp(num):
        if align_corners:
            return torch.linspace(-1.0, 1.0, num, device=theta.device)
        step = 2.0 / num
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, num,
                              device=theta.device)

    gy, gx = torch.meshgrid(linsp(h), linsp(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(theta.dtype)
    return torch.einsum("hwk,njk->nhwj", base, theta)


def normalize(x: torch.Tensor, p: float = 2, axis: int = 1,
              epsilon: float = 1e-12) -> torch.Tensor:
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=True), 1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 epsilon: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=axis, keepdim=True)
                           + epsilon)


def cos_sim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Row cosine similarity over the last dim, ``[..., 1]``."""
    return cosine_similarity(x, y, axis=-1)[..., None]


def label_smooth(label: torch.Tensor, prior_dist=None,
                 epsilon: float = 0.1) -> torch.Tensor:
    if prior_dist is None:
        return (1 - epsilon) * label + epsilon / label.shape[-1]
    return (1 - epsilon) * label + epsilon * prior_dist


def one_hot(x: torch.Tensor, num_classes: int,
            dtype="float32") -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, num_classes)`` gives a
    row of zeros."""
    from ..core.dtype import convert_dtype
    classes = torch.arange(num_classes, device=x.device)
    return (x[..., None] == classes).to(convert_dtype(dtype))


def npair_loss(anchor: torch.Tensor, positive: torch.Tensor,
               labels: torch.Tensor, l2_reg: float = 0.002) -> torch.Tensor:
    """Softmax cross entropy of ``anchor @ positive^T`` against the
    same-label distribution, plus ``l2_reg / 4`` of the mean squared
    norms."""
    reg = l2_reg * (torch.sum(anchor * anchor, 1)
                    + torch.sum(positive * positive, 1)).mean() * 0.25
    logits = anchor @ positive.T
    labels = labels.reshape(-1)
    same = (labels[:, None] == labels[None, :]).to(logits.dtype)
    prob = same / torch.sum(same, 1, keepdim=True)
    xent = -torch.sum(prob * torch.log_softmax(logits, 1), 1)
    return xent.mean() + reg


def random_crop(x: torch.Tensor, shape: Sequence[int],
                key=None) -> torch.Tensor:
    """A crop of the trailing dims to ``shape`` at an offset drawn
    uniformly for each leading-dim sample. ``key``: a ``torch.Generator``
    or an int seed (the ``random`` stream without one); the draws cannot
    be JAX's."""
    from .random_ops import draw_with
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    lead, tail = tuple(x.shape[:x.ndim - nd]), tuple(x.shape[x.ndim - nd:])
    n = 1
    for d in lead:
        n *= d
    flat = x.reshape((n,) + tail)
    highs = torch.tensor([dim - out + 1 for dim, out in zip(tail, shape)],
                         device=x.device)
    starts = draw_with(key, x.device, lambda g: torch.rand(
        (n, nd), generator=g, device=x.device))
    starts = torch.minimum((starts * highs).long(), highs - 1)
    out = flat
    for d, size in enumerate(shape):
        idx = starts[:, d, None] + torch.arange(size, device=x.device)
        view = (n,) + (1,) * d + (size,) + (1,) * (nd - d - 1)
        out = out.gather(1 + d, idx.reshape(view).expand(
            (n,) + tuple(out.shape[1:1 + d]) + (size,)
            + tuple(out.shape[2 + d:])))
    return out.reshape(lead + shape)


def add_position_encoding(x: torch.Tensor, alpha: float = 1.0,
                          beta: float = 1.0) -> torch.Tensor:
    """``alpha x + beta PE`` with the sinusoid table (sin then cos halves,
    ``div = exp(-log(10000) i / max(C / 2 - 1, 1))``), ``x`` [B, T, C]."""
    import math
    t, c = x.shape[1], x.shape[2]
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    half = c // 2
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                    * (-math.log(10000.0) / max(half - 1, 1)))
    pe = torch.cat([torch.sin(pos * div), torch.cos(pos * div)], 1)
    if pe.shape[1] < c:
        pe = tF.pad(pe, (0, c - pe.shape[1]))
    return alpha * x + beta * pe[None].to(x.dtype)


def similarity_focus(x: torch.Tensor, axis: int, indexes) -> torch.Tensor:
    """The focus mask of a 4-D ``x``: for each index along ``axis``, 1 at
    the argmax (first on a tie) of every row and every column of that
    slice."""
    if axis != 1:
        x = torch.movedim(x, axis, 1)
    b, _, h, w = x.shape
    mask = torch.zeros_like(x)
    for idx in indexes:
        sl = x[:, idx]
        m = torch.zeros((b, h, w), dtype=x.dtype, device=x.device)
        m.scatter_(2, sl.argmax(2, keepdim=True), 1.0)
        m.scatter_(1, sl.argmax(1, keepdim=True), 1.0)
        mask[:, idx] = m
    if axis != 1:
        mask = torch.movedim(mask, 1, axis)
    return mask


def continuous_value_model(input: torch.Tensor, cvm,
                           use_cvm: bool = True) -> torch.Tensor:
    """``input`` [B, D] whose first two slots are show/click placeholders,
    ``cvm`` [B, 2] the counts: ``(log(show + 1), log(click + 1) -
    log(show + 1))`` in their place, or both slots stripped."""
    cvm = torch.as_tensor(cvm, device=input.device)
    show = torch.log(cvm[:, 0:1] + 1.0)
    click = torch.log(cvm[:, 1:2] + 1.0) - show
    if use_cvm:
        return torch.cat([show, click, input[:, 2:]], 1)
    return input[:, 2:]


def deformable_roi_pooling(feat: torch.Tensor, rois: torch.Tensor,
                           trans: torch.Tensor, output_size,
                           roi_batch_idx=None, spatial_scale: float = 1.0,
                           trans_std: float = 0.1,
                           samples_per_bin: int = 2) -> torch.Tensor:
    """ROI pooling with learned per-bin offsets: each bin of each ROI (x1,
    y1, x2, y2) averages a ``samples_per_bin`` square grid of bilinear
    samples shifted by ``trans`` [R, 2, PH, PW] x ``trans_std`` x the
    ROI's size, clamped into the map. Returns [R, C, PH, PW]."""
    from .detection import _bilinear_sample
    ph, pw = (output_size, output_size) if isinstance(output_size, int) \
        else output_size
    h, w = feat.shape[-2:]
    r = rois.shape[0]
    if roi_batch_idx is None:
        roi_batch_idx = torch.zeros(r, dtype=torch.long, device=feat.device)
    box = rois * spatial_scale
    x1, y1 = box[:, 0], box[:, 1]
    rw = torch.clamp(box[:, 2] - x1, min=1.0)
    rh = torch.clamp(box[:, 3] - y1, min=1.0)
    sp = samples_per_bin
    sub = (torch.arange(sp, device=feat.device, dtype=feat.dtype) + 0.5) / sp
    ys = y1[:, None, None] + (torch.arange(ph, device=feat.device)[:, None]
                              + sub[None, :])[None] * (rh / ph)[:, None, None]
    xs = x1[:, None, None] + (torch.arange(pw, device=feat.device)[:, None]
                              + sub[None, :])[None] * (rw / pw)[:, None, None]
    # [R, PH, PW, sp, sp], offset-shifted per bin
    yy = ys[:, :, None, :, None] + (trans[:, 1] * trans_std
                                    * rh[:, None, None])[..., None, None]
    xx = xs[:, None, :, None, :] + (trans[:, 0] * trans_std
                                    * rw[:, None, None])[..., None, None]
    yy = torch.clamp(yy, 0.0, h - 1.0)
    xx = torch.clamp(xx, 0.0, w - 1.0)
    vals = _bilinear_sample(feat[torch.as_tensor(roi_batch_idx).long()],
                            yy, xx)
    return vals.mean((-2, -1))


def dropout_keep_mask(key, keep_prob: float, shape,
                      device=None) -> torch.Tensor:
    """A Bernoulli(``keep_prob``) boolean mask of ``shape``: uniform 32-bit
    draws below ``keep_prob * 2^32``. ``key``: a ``torch.Generator`` (its
    device is the mask's), an int seed or None (the ``random`` stream),
    drawn on ``device`` (None: the card); the draws cannot be JAX's."""
    from ._common import device_of
    from .random_ops import draw_with
    device = key.device if isinstance(key, torch.Generator) \
        else device_of(device=device)
    thresh = min(int(keep_prob * (2.0 ** 32)), 2 ** 32 - 1)
    bits = draw_with(key, device, lambda g: torch.randint(
        0, 2 ** 32, tuple(shape), generator=g, device=device,
        dtype=torch.int64))
    return bits < thresh


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight (+ bias)`` with ``weight`` ``[in, out]`` (the
    reference fc convention, never torch's ``[out, in]``)."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


fc = linear


def embedding(ids: torch.Tensor, weight: torch.Tensor,
              padding_idx: Optional[int] = None) -> torch.Tensor:
    """``weight[ids]``; rows of ``padding_idx`` read as zeros."""
    out = weight[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


lookup_table = embedding


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train", key=None) -> torch.Tensor:
    """Paddle's dropout: ``upscale_in_train`` is ``where(keep, x / (1 -
    p), 0)`` in training and the identity in eval; ``downscale_in_infer``
    keeps ``x`` unscaled in training and gives ``x (1 - p)`` in eval.
    Keep is a Bernoulli(1 - p) draw from the ``dropout`` stream of
    ``core.random``, or from ``key`` (a ``torch.Generator`` or an int
    seed)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if key is None:
        from ..core import random as _random
        keep = _random.draw("dropout", x.device, lambda gen: torch.rand(
            x.shape, generator=gen, device=x.device) < (1.0 - p))
    else:
        from .random_ops import draw_with
        keep = draw_with(key, x.device, lambda gen: torch.rand(
            x.shape, generator=gen, device=x.device) < (1.0 - p))
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, epsilon: float = 1e-5,
               begin_norm_axis: int = -1) -> torch.Tensor:
    """LayerNorm over dims ``[begin_norm_axis:)``: population variance
    (``jnp.var``) with eps inside the rsqrt."""
    if begin_norm_axis < 0:
        begin_norm_axis += x.ndim
    dims = tuple(range(begin_norm_axis, x.ndim))
    mean = x.mean(dim=dims, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=dims, keepdim=True)
    out = xc * torch.rsqrt(var + epsilon)
    norm_shape = x.shape[begin_norm_axis:]
    if weight is not None:
        out = out * weight.reshape(norm_shape)
    if bias is not None:
        out = out + bias.reshape(norm_shape)
    return out
