"""Hand-written CUDA kernels for the hot ops, and their routing.

Counterpart of ``paddle_tpu.kernels``. Each ``maybe_*`` entry routes by
the tensor's device: a CPU tensor goes to the kernel's plain PyTorch
version, a CUDA tensor to the kernel, which launches or raises. There is
no silent fallback from the kernel to the plain version, and no shape
gate: the TPU kernels' tiling limits (layer norm's cols % 128 and
rows >= 8) do not apply to these kernels.

``maybe_flash_attention`` keeps the JAX package's routing gate (head
dim, mask shape, train/eval minimum sequence length): what the gate
admits goes to flash attention (kernels on CUDA, their plain version on
the CPU), the rest to the plain ``ops.attention`` composition.
``maybe_flash_attention_with_lse`` is the entry ring attention builds on
(``(out, lse)``, both differentiable; no gate, as in the JAX package).
``maybe_fused_linear_xent`` routes by the ``fused_softmax_xent`` flag:
off, the composed projection and ``ops.loss``; on, the fused kernels (or
their plain version). ``maybe_fused_adam`` is the optimizer's one call
per route and step.

Where no gradient is wanted (grad mode off, or no operand requiring one)
the layer-norm and flash routes call the kernels' forwards as operators
of their own (``kernels.custom_ops``), which ``torch.export`` records in
an exported program (``jit.save``).

Each kernel counts its launches; ``launch_counts()`` reads the counts
and ``reset_launch_counts()`` sets them to 0, so a run can show that its
main path went through the kernels. A captured train step adds what its
graph launches at each replay (``add_launch_counts``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ..core import random as _random
from ..flags import GLOBAL_FLAGS
from ..nn import functional as F
from ..ops.attention import scaled_dot_product_attention
from ..ops.loss import softmax_with_cross_entropy
from . import custom_ops as _ops
from . import flash_attention as _fa
from . import fused_adam as _adam
from . import fused_softmax_xent as _fx
from . import layer_norm as _ln
from . import paged_attention as _pa

__all__ = ["maybe_layer_norm", "maybe_paged_attention",
           "maybe_paged_attention_multiquery", "maybe_flash_attention",
           "maybe_flash_attention_with_lse",
           "fused_softmax_xent_enabled", "maybe_fused_linear_xent",
           "maybe_fused_adam", "launch_counts", "reset_launch_counts",
           "add_launch_counts"]

# (module, counter attribute) of every kernel, by the name launch_counts()
# reports
_COUNTERS = {
    "layer_norm": (_ln, "launches"),
    "paged_attention": (_pa, "launches"),
    "paged_attention_multiquery": (_pa, "mq_launches"),
    "flash_attention_fwd": (_fa, "fwd_launches"),
    "flash_attention_bwd_fused": (_fa, "fused_launches"),
    "flash_attention_bwd_dq": (_fa, "dq_launches"),
    "flash_attention_bwd_dkv": (_fa, "dkv_launches"),
    "fused_xent_fwd": (_fx, "fwd_launches"),
    "fused_xent_bwd_dlog": (_fx, "dlog_launches"),
    "fused_xent_bwd_dh": (_fx, "dh_launches"),
    "fused_xent_bwd_dw": (_fx, "dw_launches"),
    "adam_leaf": (_adam, "leaf_launches"),
    "adam_flat": (_adam, "flat_launches"),
}

# The eval floor for head dims that are not a multiple of 128 (BERT's 64):
# a fixed memory bound, not the flash_attention_min_seq flag (the JAX
# package's kernels._NARROW_HEAD_EVAL_MIN_SEQ).
_NARROW_HEAD_EVAL_MIN_SEQ = 8192


def launch_counts() -> Dict[str, int]:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)


def add_launch_counts(counts: Dict[str, int], times: int = 1) -> None:
    """Adds ``times`` x ``counts`` (name -> launches) to the counters:
    a CUDA graph's replay launches what its capture recorded without
    running a wrapper (``static.TrainStep``)."""
    for name, n in counts.items():
        mod, attr = _COUNTERS[name]
        setattr(mod, attr, getattr(mod, attr) + n * times)


def maybe_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, epsilon: float,
                     begin_norm_axis: int) -> torch.Tensor:
    """Affine LayerNorm over dims ``[begin_norm_axis:)``. Where no
    gradient is wanted it is the ``paddle_tpu_torch::layer_norm`` operator
    (``kernels.custom_ops``: what ``torch.export`` records), with the same
    implementations as below."""
    if not _ops.wants_grad(x, weight, bias):
        return _ops.layer_norm(x, weight, bias, float(epsilon),
                               int(begin_norm_axis))
    if x.device.type == "cpu":
        return F.layer_norm(x, weight, bias, epsilon, begin_norm_axis)
    # the kernel normalises the last dim: trailing normalised dims merge
    # into one (a no-op for the usual single normalised dim)
    return _ln.layer_norm(x.flatten(begin_norm_axis), weight.reshape(-1),
                          bias.reshape(-1), epsilon).reshape(x.shape)


def maybe_paged_attention(q, k_pool, v_pool, block_tables, context_lens,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Ragged single-query paged decode attention (q [B, H, D], pools
    [N, block_size, H, D]; see kernels/paged_attention.py)."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pool, v_pool, block_tables,
                                         context_lens, scale)
    return _pa.paged_attention(q, k_pool, v_pool, block_tables,
                               context_lens, scale)


def maybe_paged_attention_multiquery(q, q_lens, k_pool, v_pool,
                                     block_tables, context_lens,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Ragged multi-query paged attention for the speculative verify
    step (q [B, Qmax, H, D] plus per-sequence q_lens)."""
    if q.device.type == "cpu":
        return _pa.paged_attention_multiquery_plain(
            q, q_lens, k_pool, v_pool, block_tables, context_lens, scale)
    return _pa.paged_attention_multiquery(q, q_lens, k_pool, v_pool,
                                          block_tables, context_lens, scale)


def _is_key_padding_mask(mask, batch: int, tk: int) -> bool:
    """True for exactly-shaped [B, 1, 1, Tk] masks (no broadcasting)."""
    return (getattr(mask, "ndim", 0) == 4 and mask.shape[0] == batch
            and mask.shape[1] == 1 and mask.shape[2] == 1
            and mask.shape[3] == tk)


def _mask_to_kv_bias(mask: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, 1, 1, Tk] mask -> [B, Tk] additive key bias in ``dtype`` (fp32,
    the kernels'; fp64 for a float64 run's plain version). A bool mask
    is a KEEP mask (True attends); a float mask is already additive."""
    if mask.dtype == torch.bool:
        return torch.where(mask[:, 0, 0, :], 0.0,
                           _fa.NEG_INF).to(dtype).contiguous()
    return mask[:, 0, 0, :].to(dtype).contiguous()


def maybe_flash_attention(q, k, v, mask=None, scale: Optional[float] = None,
                          causal: bool = False, dropout_p: float = 0.0,
                          training: bool = False,
                          layout: str = "bhtd") -> torch.Tensor:
    """Attention over q/k/v ``[B, H, T, D]`` (``layout="bhtd"``) or
    ``[B, T, H, D]`` (``"bthd"``); the output keeps the input layout.

    The JAX package's gate, as written: flash attention only when the
    head dim suits it (``d % 128 == 0``, or ``d % 8 == 0`` in training
    or at eval lengths >= 8192), the mask is absent or exactly
    ``[B, 1, 1, Tk]`` (it becomes the kernels' key bias), and the key
    length reaches ``flash_attention_min_seq`` (eval) or
    ``flash_attention_min_seq_train`` (training, 0 = the eval flag).
    Admitted calls run the CUDA kernels on CUDA tensors and their plain
    version on CPU tensors; with dropout in training each call draws its
    kernel seed, a one-element device tensor, from the ``dropout``
    stream. An admitted call without dropout that wants no gradient is
    the ``paddle_tpu_torch::flash_attention`` operator (the forward
    alone; ``kernels.custom_ops``). The rest runs
    ``ops.attention.scaled_dot_product_attention``.

    The CUDA kernels take every head dim the gate admits: those outside
    ``flash_attention.HEAD_DIMS`` are zero-padded to the next one, and
    a head dim above 512 runs as slices of one of them
    (``flash_attention.head_dim_plan``).
    """
    bthd = layout == "bthd"
    t_axis = 1 if bthd else 2
    d = q.shape[-1]
    tk = k.shape[t_axis]
    d_ok = d % 128 == 0 or (d % 8 == 0 and (
        training or tk >= _NARROW_HEAD_EVAL_MIN_SEQ))
    mask_ok = mask is None or _is_key_padding_mask(mask, q.shape[0], tk)
    min_seq = GLOBAL_FLAGS.get("flash_attention_min_seq")
    if training:
        min_seq = GLOBAL_FLAGS.get("flash_attention_min_seq_train") \
            or min_seq
    if mask_ok and q.ndim == 4 and d_ok and tk >= min_seq:
        kv_bias = None if mask is None else _mask_to_kv_bias(
            mask, torch.float64 if q.dtype == torch.float64
            else torch.float32)
        if not (dropout_p > 0.0 and training) \
                and not _ops.wants_grad(q, k, v):
            return _ops.flash_attention(q, k, v, kv_bias, bool(causal),
                                        scale, bthd)
        seed, p = None, 0.0
        if dropout_p > 0.0 and training:
            gen = _random.next_generator("dropout", q.device)
            seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                                 device=q.device, dtype=torch.int32)
            p = float(dropout_p)
        impl = _fa.flash_attention_plain if q.device.type == "cpu" \
            else _fa.flash_attention
        return impl(q, k, v, causal=causal, scale=scale, dropout_p=p,
                    seed=seed, kv_bias=kv_bias, bthd=bthd)
    if bthd:
        out = scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            mask=mask, scale=scale, causal=causal, dropout_p=dropout_p,
            training=training)
        return out.transpose(1, 2)
    return scaled_dot_product_attention(q, k, v, mask=mask, scale=scale,
                                        causal=causal, dropout_p=dropout_p,
                                        training=training)


def maybe_flash_attention_with_lse(q, k, v, causal: bool = False,
                                   scale: Optional[float] = None,
                                   layout: str = "bhtd"):
    """``(out, lse)`` of attention over q/k/v ``[B, H, T, D]``
    (``layout="bhtd"``) or ``[B, T, H, D]`` (``"bthd"``), both
    differentiable; lse ``[B, H, Tq]`` fp32, out in q's layout and dtype.
    No dropout and no bias, as the JAX package's
    ``flash_attention_with_lse``. CPU tensors take the plain version,
    CUDA tensors the flash kernels (or raise)."""
    impl = _fa.flash_attention_with_lse_plain if q.device.type == "cpu" \
        else _fa.flash_attention_with_lse
    return impl(q, k, v, causal=causal, scale=scale, bthd=layout == "bthd")


def fused_softmax_xent_enabled() -> bool:
    """The ``fused_softmax_xent`` flag: BERT's MLM head hands its hidden
    states to the loss (``MLMHeadOutput``) instead of logits."""
    return bool(GLOBAL_FLAGS.get("fused_softmax_xent"))


def maybe_fused_linear_xent(hidden: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            labels: torch.Tensor,
                            ignore_index: int = -100) -> torch.Tensor:
    """Per-position softmax cross-entropy of ``hidden @ weight.T + bias``
    (hidden ``[..., H]``, weight ``[V, H]``, bias ``[V]`` or None, integer
    labels of the leading shape): fp32 loss of labels' shape, 0 at
    ``ignore_index``. Flag off: the composed projection and
    ``ops.loss.softmax_with_cross_entropy``. Flag on: the fused kernels
    for CUDA tensors (the logits never exist in device memory), their
    plain version for CPU tensors."""
    if not fused_softmax_xent_enabled():
        logits = hidden @ weight.T
        if bias is not None:
            logits = logits + bias
        return softmax_with_cross_entropy(
            logits, labels[..., None], ignore_index=ignore_index)[..., 0]
    if hidden.device.type == "cpu":
        return _fx.fused_linear_xent_plain(hidden, weight, bias, labels,
                                           ignore_index)
    return _fx.fused_linear_xent(hidden, weight, bias, labels,
                                 ignore_index)


def maybe_fused_adam(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
                     decay: Sequence[bool], lr_c: torch.Tensor,
                     beta1: float, beta2: float, eps: float,
                     lr_wd: Union[float, torch.Tensor],
                     ok: Optional[torch.Tensor] = None,
                     variant: str = "leaf") -> None:
    """Paddle's Adam update of every given leaf in place (variant
    ``"leaf"`` or ``"flat"``, see ``kernels/fused_adam.py``): one kernel
    launch for CUDA tensors, the plain version for CPU tensors."""
    impl = _adam.adam_multi_plain if params and \
        params[0].device.type == "cpu" else _adam.adam_multi
    impl(params, grads, ms, vs, decay, lr_c, beta1, beta2, eps, lr_wd, ok,
         variant)
