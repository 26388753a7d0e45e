"""``fluid.nets`` composite layers: ``simple_img_conv_pool``,
``img_conv_group``, ``sequence_conv_pool``, ``glu`` and
``scaled_dot_product_attention``.

Counterpart of ``paddle_tpu.nets``, over the port's ``ops`` modules. As
there, the composites take their weights explicitly (as ``layers.fc`` and
``layers.embedding`` do); a model that owns its parameters composes
``nn.Conv2D``/``nn.BatchNorm2D``/``nn.Sequential`` instead.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .ops import activation as _act
from .ops._common import as_tensor
from .ops import nn_functional as _F
from .ops import sequence as _seq
from .ops.activation import glu  # noqa: F401  (ref nets.py:328)
from .ops.attention import \
    scaled_dot_product_attention  # noqa: F401  (ref nets.py:372)

__all__ = ["simple_img_conv_pool", "img_conv_group",
           "sequence_conv_pool", "glu", "scaled_dot_product_attention"]


def _check_kernel(weight, filter_size, fn_name: str) -> None:
    fs = (filter_size, filter_size) if isinstance(filter_size, int) \
        else tuple(filter_size)
    if tuple(weight.shape[2:]) != fs:
        raise ValueError(
            f"{fn_name}: conv weight kernel {tuple(weight.shape[2:])} "
            f"does not match filter_size {fs}")


def _apply_act(x, act: Optional[str]):
    return x if act is None else getattr(_act, act)(x)


def _pool2d(x, pool_size, pool_type: str, pool_stride=1, pool_padding=0,
            global_pooling: bool = False):
    if global_pooling:
        pool_size = x.shape[2:]
        pool_stride, pool_padding = 1, 0
    fn = _F.max_pool2d if pool_type == "max" else _F.avg_pool2d
    return fn(x, pool_size, stride=pool_stride, padding=pool_padding)


def simple_img_conv_pool(input, num_filters: int, filter_size,
                         pool_size, pool_stride, conv_weight,
                         conv_bias=None, pool_padding=0,
                         pool_type: str = "max",
                         global_pooling: bool = False, conv_stride=1,
                         conv_padding=0, conv_dilation=1,
                         conv_groups: int = 1,
                         act: Optional[str] = None):
    """conv2d → activation → pool2d (ref: fluid/nets.py:29).

    ``conv_weight``: [num_filters, C/groups, kh, kw]; pass
    ``pool_type="avg"`` / ``global_pooling=True`` as in the reference.
    """
    if conv_weight.shape[0] != num_filters:
        raise ValueError(
            f"simple_img_conv_pool: conv_weight has "
            f"{conv_weight.shape[0]} output channels, expected "
            f"{num_filters}")
    _check_kernel(conv_weight, filter_size, "simple_img_conv_pool")
    out = _F.conv2d(input, conv_weight, conv_bias, stride=conv_stride,
                    padding=conv_padding, dilation=conv_dilation,
                    groups=conv_groups)
    out = _apply_act(out, act)
    return _pool2d(out, pool_size, pool_type, pool_stride, pool_padding,
                   global_pooling)


def img_conv_group(input, conv_num_filter: Sequence[int], pool_size,
                   conv_weights: Sequence, conv_biases=None,
                   bn_params=None, conv_padding=1, conv_filter_size=3,
                   conv_act: Optional[str] = None,
                   conv_with_batchnorm: bool = False,
                   conv_batchnorm_drop_rate: float = 0.0,
                   pool_stride=1, pool_type: str = "max",
                   training: bool = True):
    """Stacked conv(+BN)(+dropout) blocks then one pool — the VGG block
    (ref: fluid/nets.py:141).

    ``conv_weights``: one [out, in, k, k] kernel per entry of
    ``conv_num_filter``. With ``conv_with_batchnorm=True`` pass
    ``bn_params`` as a list of (gamma, beta, running_mean, running_var)
    tuples, one per conv; like the reference, dropout after BN uses
    ``conv_batchnorm_drop_rate`` (0 disables).
    """
    n = len(conv_num_filter)
    if len(conv_weights) != n:
        raise ValueError(
            f"img_conv_group: {len(conv_weights)} weights for {n} convs")
    if isinstance(conv_filter_size, list):
        fsizes = conv_filter_size
        if len(fsizes) != n:
            raise ValueError(
                f"img_conv_group: {len(fsizes)} filter sizes for {n} "
                f"convs")
    else:  # one size (int or (kh, kw) tuple) shared by every conv
        fsizes = [conv_filter_size] * n
    for i, (w_, fs) in enumerate(zip(conv_weights, fsizes)):
        _check_kernel(w_, fs, f"img_conv_group conv {i}")
    if conv_with_batchnorm and (bn_params is None or len(bn_params) != n):
        raise ValueError(
            "img_conv_group: conv_with_batchnorm=True needs one "
            "(gamma, beta, mean, var) tuple per conv in bn_params")

    def per_conv(val):
        return val if isinstance(val, (list, tuple)) else [val] * n

    paddings = per_conv(conv_padding)
    out = input
    for i in range(n):
        bias = conv_biases[i] if conv_biases is not None else None
        out = _F.conv2d(out, conv_weights[i], bias,
                        padding=paddings[i])
        if out.shape[1] != conv_num_filter[i]:
            raise ValueError(
                f"img_conv_group: conv {i} produced {out.shape[1]} "
                f"channels, expected {conv_num_filter[i]}")
        if conv_with_batchnorm:
            gamma, beta, mean, var = bn_params[i]
            out, _, _ = _F.batch_norm(out, mean, var, gamma, beta,
                                      training=training)
            out = _apply_act(out, conv_act)
            if conv_batchnorm_drop_rate > 0.0:
                out = _F.dropout(out, conv_batchnorm_drop_rate,
                                 training=training)
        else:
            out = _apply_act(out, conv_act)
    return _pool2d(out, pool_size, pool_type, pool_stride)


def sequence_conv_pool(input, length, num_filters: int, filter_size: int,
                       weight, bias=None, act: Optional[str] = "sigmoid",
                       pool_type: str = "max"):
    """sequence_conv → activation → sequence_pool (ref:
    fluid/nets.py:256; text-conv building block).

    Dense redesign: ``input`` is [B, T, D] with per-row ``length``
    (the LoD analogue); ``weight`` is [filter_size * D, num_filters].
    Returns [B, num_filters].
    """
    d = input.shape[-1]
    if weight.shape != (filter_size * d, num_filters):
        raise ValueError(
            f"sequence_conv_pool: weight shape {tuple(weight.shape)} != "
            f"({filter_size * d}, {num_filters})")
    length = as_tensor(length, like=input)
    # reference: context_start = -floor(filter_size/2) centers the window
    out = _seq.sequence_conv(input, length, weight, filter_size,
                             context_start=-(filter_size // 2), bias=bias)
    out = _apply_act(out, act)
    return _seq.sequence_pool(out, length, pool_type)
