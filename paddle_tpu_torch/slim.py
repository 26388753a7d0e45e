"""Quantization: QAT fake-quant, post-training calibration and int8
deployment.

Counterpart of ``paddle_tpu.slim`` (the reference's
contrib/slim/quantization: QuantizationTransformPass inserting
fake_quantize_abs_max / fake_quantize_moving_average_abs_max /
fake_channel_wise_quantize ops before weights and activations,
post_training_quantization.py, the C++ fake_quantize_op.cc).

- The fake-quant ops are plain functions whose rounding passes the
  gradient straight through (an ``autograd.Function``; a
  ``jax.custom_vjp`` in the JAX package), in the JAX order of operations
  (``clip(x / scale) * n``, round, then ``* scale / n``); the abs-max
  scales are ``amax`` reductions, whose gradient splits ties evenly as
  JAX's ``max`` does. Both packages round half to even.
- :func:`quantize_model` swaps every ``nn.Linear`` child for a
  :class:`QuantizedLinear` that wraps it, so the parameters keep the JAX
  names (``...q_proj.inner.weight``) beside an ``act_scale`` buffer. In
  training mode the EMA activation scale is written into that buffer in
  place (the JAX layer rebinds it), so a captured ``static.TrainStep``
  updates it at every replay.
- :class:`PostTrainingQuantization` runs calibration batches with only
  the ``QuantizedLinear`` layers in training mode, and ``quantize()``
  rounds every weight matrix to its grid.
- :class:`Int8Linear` (:func:`convert_to_int8`) stores ``int8`` weights
  (``w_q``), the per-channel ``w_scale``, ``act_scale`` and ``bias_f``,
  quantizes the activation to ``int8`` and multiplies ``int8 x int8 ->
  int32`` exactly: ``torch._int_mm`` on the card (the JAX package's
  ``lax.dot_general(preferred_element_type=int32)``, outside any Pallas
  kernel), with the operands padded with zero rows and columns to the
  shapes it takes (exact in integers), and an int32 matmul on the CPU.
  No product goes through floats: fp32 is exact only below 2^24, and
  127^2 x 3072 is about 4.95e7.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from .nn.layer import Layer

__all__ = ["fake_quantize_abs_max", "fake_quantize_moving_average_abs_max",
           "fake_channel_wise_quantize_abs_max", "QuantizedLinear",
           "quantize_model", "PostTrainingQuantization", "Int8Linear",
           "convert_to_int8"]

# torch._int_mm's shape rules on the card (torch 2.11.0+cu128 on an H100
# refuses 8 and 16 rows and an output dim of 2; takes 17 rows, an inner
# dim of 8 or 16 and an output dim of 8): more than 16 rows, the inner
# and output dims multiples of 8
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _quant_levels(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


class _STERound(torch.autograd.Function):
    """Round half to even; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    return _STERound.apply(x)


def _floor(scale: torch.Tensor) -> torch.Tensor:
    """``max(scale, 1e-8)`` with JAX's ``maximum`` gradient."""
    return torch.maximum(scale, torch.full_like(scale, 1e-8))


def fake_quantize_abs_max(x: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor fake quant (ref: fake_quantize_op.cc
    FakeQuantizeAbsMaxOp). Returns (quant-dequant x, scale)."""
    n = _quant_levels(bits)
    scale = _floor(torch.amax(torch.abs(x)))
    q = _ste_round(torch.clamp(x / scale, -1.0, 1.0) * n)
    return q * scale / n, scale


def fake_channel_wise_quantize_abs_max(w: torch.Tensor, bits: int = 8,
                                       axis: int = 0):
    """Per-output-channel weight fake quant (ref: fake_quantize_op.cc
    FakeChannelWiseQuantizeAbsMaxOp): one scale for each index of
    ``axis``."""
    n = _quant_levels(bits)
    red = tuple(i for i in range(w.ndim) if i != axis)
    scale = _floor(torch.amax(torch.abs(w), dim=red, keepdim=True))
    q = _ste_round(torch.clamp(w / scale, -1.0, 1.0) * n)
    return q * scale / n, torch.squeeze(scale)


def fake_quantize_moving_average_abs_max(x: torch.Tensor,
                                         state_scale: torch.Tensor,
                                         bits: int = 8,
                                         momentum: float = 0.9,
                                         training: bool = True):
    """Activation fake quant with an EMA scale (ref: fake_quantize_op.cc
    FakeQuantizeMovingAverageAbsMaxOp). Returns (out, new_scale)."""
    n = _quant_levels(bits)
    if training:
        cur = _floor(torch.amax(torch.abs(x)))
        scale = momentum * state_scale + (1 - momentum) * cur
    else:
        scale = state_scale
    scale = _floor(scale)
    q = _ste_round(torch.clamp(x / scale, -1.0, 1.0) * n)
    return q * scale / n, scale


class QuantizedLinear(Layer):
    """A Linear with channel-wise weight and EMA activation fake quant,
    what QuantizationTransformPass turns a mul/matmul into. ``inner``
    is the wrapped ``nn.Linear`` (its parameters keep their names under
    ``inner.``); ``act_scale`` is a buffer."""

    def __init__(self, inner, weight_bits: int = 8,
                 activation_bits: int = 8) -> None:
        super().__init__()
        self.inner = inner
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.register_buffer("act_scale", torch.ones(
            (), dtype=torch.float32, device=inner.weight.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a captured step's key holds every module's training mode, this
        # layer's too (a calibration flips these layers alone)
        x, new_scale = fake_quantize_moving_average_abs_max(
            x, self.act_scale, bits=self.activation_bits,
            training=self.training)
        if self.training:
            with torch.no_grad():
                self.act_scale.copy_(new_scale)
        w = self.inner.weight
        wq, _ = fake_channel_wise_quantize_abs_max(
            w, bits=self.weight_bits, axis=w.ndim - 1)
        out = x @ wq
        bias = self.inner.bias
        if bias is not None:
            out = out + bias
        return out


def quantize_model(model: nn.Module, weight_bits: int = 8,
                   activation_bits: int = 8,
                   quantizable=("Linear",)) -> nn.Module:
    """Swaps every quantizable child for a fake-quant wrapper, in place
    (the dygraph form of the reference's IR pass; cf. slim/quantization/
    imperative/qat.py ImperativeQuantAware). Returns the model."""
    from .nn.layers import Linear
    for name, child in list(model._modules.items()):
        if child is None:
            continue
        if type(child).__name__ in quantizable and \
                isinstance(child, Linear):
            model._modules[name] = QuantizedLinear(child, weight_bits,
                                                   activation_bits)
        else:
            quantize_model(child, weight_bits, activation_bits,
                           quantizable)
    return model


def _tensor_leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensor_leaves(o)]
    if isinstance(out, dict):
        return [t for o in out.values() for t in _tensor_leaves(o)]
    return []


class PostTrainingQuantization:
    """Calibrates the activation scales on sample batches, then rounds
    the weights to their grid (ref: post_training_quantization.py
    PostTrainingQuantization.quantize)."""

    def __init__(self, model: nn.Module, weight_bits: int = 8,
                 activation_bits: int = 8) -> None:
        self.model = model
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_scales: Dict[str, float] = {}

    def calibrate(self, batches: Sequence) -> "PostTrainingQuantization":
        """Calibration forwards (no gradient). The EMA ``act_scale``
        buffers move in training mode alone, so ONLY the
        ``QuantizedLinear`` layers are flipped to training for the
        passes (dropout and the rest keep their mode) and restored
        after. ``act_scales["output"]`` keeps the largest |output| (over
        every tensor the model returns; the JAX package takes one
        array)."""
        qlayers = [m for m in self.model.modules()
                   if isinstance(m, QuantizedLinear)]
        prev = [m.training for m in qlayers]
        for m in qlayers:
            m.training = True
        try:
            with torch.no_grad():
                for batch in batches:
                    args = batch if isinstance(batch, (tuple, list)) \
                        else (batch,)
                    out = self.model(*args)
                    cur = max(float(torch.amax(torch.abs(t)))
                              for t in _tensor_leaves(out))
                    self.act_scales["output"] = max(
                        self.act_scales.get("output", 0.0), cur)
        finally:
            for m, p in zip(qlayers, prev):
                m.training = p
        return self

    def quantize(self) -> nn.Module:
        """Rounds every weight of two or more dims to its
        ``weight_bits`` grid, in place (a simulated int8 deployment;
        :func:`convert_to_int8` is the real one)."""
        with torch.no_grad():
            for p in self.model.parameters():
                if p.ndim >= 2:
                    wq, _ = fake_channel_wise_quantize_abs_max(
                        p, bits=self.weight_bits, axis=p.ndim - 1)
                    p.copy_(wq)
        return self.model


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ b [K, N] int8`` as exact int32: ``torch._int_mm``
    on the card over operands zero-padded to its shape rules (then
    sliced), an int32 matmul on the CPU."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    m, k = a.shape
    n = b.shape[1]
    mp = max(m, _INT_MM_MIN_ROWS)
    kp, np_ = _round_up(k, _INT_MM_ALIGN), _round_up(n, _INT_MM_ALIGN)
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:m, :n] if (mp, np_) != (m, n) else out


class Int8Linear(Layer):
    """The int8 deployment Linear: int8 weights and activations, exact
    int32 accumulation (see the module note), the deployment form of
    :class:`QuantizedLinear` (ref capability: the reference's
    quantize/dequantize + int8 kernels, quantize_op.cc)."""

    def __init__(self, w_q, w_scale, act_scale, bias=None) -> None:
        super().__init__()
        dev = torch.as_tensor(w_q).device
        self.register_buffer("w_q", torch.as_tensor(w_q).to(torch.int8))
        self.register_buffer("w_scale", torch.as_tensor(
            w_scale, device=dev).to(torch.float32))
        self.register_buffer("act_scale", torch.as_tensor(
            act_scale, device=dev).to(torch.float32))
        self.register_buffer("bias_f", None if bias is None else
                             torch.as_tensor(bias, device=dev)
                             .to(torch.float32))
        self.n_weight = 127.0
        self.n_act = 127.0

    def accumulate(self, x: torch.Tensor) -> torch.Tensor:
        """The int32 accumulator ``[rows, out]`` of ``x``'s int8 grid
        (its leading dims flattened) against ``w_q``."""
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        n_a = self.n_act
        inv = n_a / _floor(self.act_scale)
        xq = torch.clamp(torch.round(xf * inv), -n_a, n_a).to(torch.int8)
        return int8_matmul(xq, self.w_q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = tuple(x.shape[:-1])
        acc = self.accumulate(x)
        out = acc.to(torch.float32) * (self.act_scale / self.n_act) * (
            self.w_scale[None, :] / self.n_weight)
        if self.bias_f is not None:
            out = out + self.bias_f
        return out.reshape(lead + (out.shape[-1],)).to(x.dtype)

    @classmethod
    def from_quantized(cls, q: QuantizedLinear) -> "Int8Linear":
        """The int8 form of a calibrated fake-quant layer (QAT or PTQ):
        its bit widths (<= 8; the int8 carrier holds any narrower grid)
        and the fake-quant path's per-channel scale rule (the 1e-8 floor
        included), so deployment reproduces the grid QAT trained on."""
        if q.weight_bits > 8 or q.activation_bits > 8:
            raise ValueError(
                f"Int8Linear carries at most 8 bits; got weight_bits="
                f"{q.weight_bits} activation_bits={q.activation_bits}")
        with torch.no_grad():
            w = q.inner.weight.detach()
            n_w = _quant_levels(q.weight_bits)
            _, w_scale = fake_channel_wise_quantize_abs_max(
                w, bits=q.weight_bits, axis=w.ndim - 1)
            w_q = torch.clamp(torch.round(w * (n_w / w_scale[None, :])),
                              -n_w, n_w).to(torch.int8)
            bias = q.inner.bias
            layer = cls(w_q, w_scale, q.act_scale.detach().clone(),
                        None if bias is None else bias.detach())
        layer.n_weight = n_w
        layer.n_act = _quant_levels(q.activation_bits)
        return layer


def convert_to_int8(model: nn.Module) -> nn.Module:
    """Swaps every calibrated QuantizedLinear for its Int8Linear form,
    in place (after QAT, or PTQ calibration of a
    :func:`quantize_model`-wrapped model). Returns the model."""
    for name, child in list(model._modules.items()):
        if isinstance(child, QuantizedLinear):
            model._modules[name] = Int8Linear.from_quantized(child)
        elif child is not None:
            convert_to_int8(child)
    return model
