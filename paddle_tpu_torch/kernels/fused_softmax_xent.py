"""Fused linear projection + softmax cross-entropy: the CUDA kernels'
wrappers, their autograd Function, and the plain version.

The kernels (``csrc/fused_softmax_xent.cu``) replace the Pallas kernels
of ``paddle_tpu/kernels/fused_softmax_xent.py``: ``_fwd_kernel`` (the
streamed logsumexp and picked logit), ``_bwd_dh_kernel`` and
``_bwd_dw_kernel`` (the recompute backward). The source note gives the
design and the bound.

Semantics are the JAX package's ``fused_linear_softmax_xent``: the
per-position loss of ``logits = hidden @ weight.T + bias`` (never
materialised by the kernels),

    loss_i = logsumexp_j(logits_ij) - logits_i[label_i]

in fp32, exactly 0 where ``label_i == ignore_index``; ``bias=None`` means
zeros; an ignored row gets no gradient; the labels get none. The forward
saves only ``hidden``, ``weight``, ``bias``, ``labels`` and the ``[N]``
``lse`` for the backward.

The kernels take fp32 CUDA tensors: ``hidden`` ``[..., H]``, ``weight``
``[V, H]`` contiguous (the tied word embedding is read in place),
``bias`` ``[V]`` or None, integer ``labels`` of ``hidden``'s leading
shape; anything else raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["fused_linear_xent", "fused_linear_xent_plain", "xent_fwd",
           "xent_bwd_dh", "xent_bwd_dw", "vocab_splits", "MAX_HIDDEN"]

# kernel launches since the last reset (kernels.reset_launch_counts): the
# forward entry launches two kernels (partials per vocab split, merge)
fwd_launches = 0
dh_launches = 0
dw_launches = 0

_VOCAB_TILE = 64      # vocab columns of a logits tile (kVT in the source)
_ROW_TILE = 64        # rows of a forward block
_OWN = 32             # rows (dh) or vocab rows (dW) a backward block owns
_BLOCK_SMEM = 232448  # shared memory a Hopper block may have, in bytes
# the backward keeps its [32, H] accumulator in shared memory beside its
# staging tiles (bwd_smem in the source): H up to this fits
MAX_HIDDEN = (_BLOCK_SMEM // 4 - (2 * _OWN * 36 + 2 * 64 * 36 + _OWN * 68
                                  + 2 * 64 * 68)) // _OWN


def fused_linear_xent_plain(hidden: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor],
                            labels: torch.Tensor, ignore_index: int = -100,
                            return_lse: bool = False):
    """The kernels' plain PyTorch version: materialised fp32 logits,
    ``logsumexp``, the picked logit with the label clamped into range
    before ``gather``, 0 at ``ignore_index``; autograd for the gradient.
    The oracle of the kernels and their stand-in for CPU tensors. With
    ``return_lse`` also returns the row ``lse`` ``[N]``."""
    lead = labels.shape
    h2 = hidden.reshape(-1, hidden.shape[-1]).float()
    logits = h2 @ weight.float().T
    if bias is not None:
        logits = logits + bias.float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = labels.reshape(-1).long()
    safe = lab.clamp(0, weight.shape[0] - 1)
    picked = torch.gather(logits, 1, safe[:, None])[:, 0]
    loss = torch.where(lab != ignore_index, lse - picked,
                       torch.zeros_like(lse)).reshape(lead)
    if return_lse:
        return loss, lse.detach()
    return loss


# --- the CUDA kernels ------------------------------------------------------

_sm_counts = {}


def vocab_splits(n: int, v: int, sm_count: int) -> int:
    """Vocab splits of the forward's grid: ~16 (row tile, split) blocks
    per SM, so the last partial wave is a small share of the work; at
    most one split per vocab tile."""
    row_tiles = -(-n // _ROW_TILE)
    tiles = -(-v // _VOCAB_TILE)
    return max(1, min(tiles, -(-16 * sm_count // row_tiles)))


def _sms(dev: torch.device) -> int:
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_counts[dev]


def _checked(h2, w, b, lab) -> Tuple[int, int, int]:
    """(N, V, H) of checked kernel operands."""
    for name, t in (("hidden", h2), ("weight", w), ("bias", b),
                    ("labels", lab)):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"fused softmax-xent kernel needs CUDA tensors "
                             f"({name} is on {t.device})")
    dev = h2.device
    n, hd = h2.shape
    if w.ndim != 2 or w.shape[1] != hd:
        raise ValueError(f"weight must be [V, {hd}], got {tuple(w.shape)}")
    v = w.shape[0]
    for name, t in (("hidden", h2), ("weight", w), ("bias", b)):
        if t is None:
            continue
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise TypeError(f"fused softmax-xent kernel takes contiguous "
                            f"float32 {name} on the hidden states' device "
                            f"({t.dtype}, {t.device})")
    if b is not None and b.shape != (v,):
        raise ValueError(f"bias must be [{v}], got {tuple(b.shape)}")
    if lab.shape != (n,) or lab.dtype != torch.int64 or lab.device != dev \
            or not lab.is_contiguous():
        raise TypeError(f"labels must be contiguous int64 [{n}] on the "
                        f"hidden states' device")
    if hd > MAX_HIDDEN:
        raise ValueError(f"fused softmax-xent backward holds [32, H] in "
                         f"shared memory: H <= {MAX_HIDDEN}, got {hd}")
    return n, v, hd


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def xent_fwd(h2: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             lab: torch.Tensor, ignore_index: int = -100
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels on ``h2`` ``[N, H]``: returns ``(loss, lse)``,
    both fp32 ``[N]``."""
    global fwd_launches
    n, v, hd = _checked(h2, w, b, lab)
    splits = vocab_splits(n, v, _sms(h2.device))
    part = torch.empty(3 * splits * n, dtype=torch.float32, device=h2.device)
    loss = torch.empty(n, dtype=torch.float32, device=h2.device)
    lse = torch.empty_like(loss)
    code = _build.library("fused_softmax_xent").fused_xent_fwd(
        h2.data_ptr(), w.data_ptr(), _ptr(b), lab.data_ptr(),
        part.data_ptr(), loss.data_ptr(), lse.data_ptr(), n, v, hd, splits,
        int(ignore_index), _stream(h2.device))
    _build.check("fused_softmax_xent", code, "fused_xent_fwd")
    fwd_launches += 2
    return loss, lse


def _rows(t: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
        raise TypeError(f"{what} must be contiguous float32 [{n}]")
    return t


def xent_bwd_dh(h2, w, b, lab, lse, g, ignore_index: int = -100
                ) -> torch.Tensor:
    """The dh kernel: ``dh = g (softmax - onehot) @ W`` ``[N, H]``."""
    global dh_launches
    n, v, hd = _checked(h2, w, b, lab)
    _rows(lse, n, "lse")
    _rows(g, n, "g")
    dh = torch.empty_like(h2)
    code = _build.library("fused_softmax_xent").fused_xent_bwd_dh(
        h2.data_ptr(), w.data_ptr(), _ptr(b), lab.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dh.data_ptr(), n, v, hd,
        int(ignore_index), _stream(h2.device))
    _build.check("fused_softmax_xent", code, "fused_xent_bwd_dh")
    dh_launches += 1
    return dh


def xent_bwd_dw(h2, w, b, lab, lse, g, ignore_index: int = -100
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The dW/db kernel: ``dW = (g (softmax - onehot))^T @ h`` ``[V, H]``
    and its column sums ``db`` ``[V]`` (None without a bias)."""
    global dw_launches
    n, v, hd = _checked(h2, w, b, lab)
    _rows(lse, n, "lse")
    _rows(g, n, "g")
    dw = torch.empty_like(w)
    db = None if b is None else torch.empty_like(b)
    code = _build.library("fused_softmax_xent").fused_xent_bwd_dw(
        h2.data_ptr(), w.data_ptr(), _ptr(b), lab.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dw.data_ptr(), _ptr(db), n, v, hd,
        int(ignore_index), _stream(h2.device))
    _build.check("fused_softmax_xent", code, "fused_xent_bwd_dw")
    dw_launches += 1
    return dw, db


class _FusedLinearXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, w, b, lab, ignore_index):
        loss, lse = xent_fwd(h2, w, b, lab, ignore_index)
        ctx.save_for_backward(h2, w, b, lab, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        h2, w, b, lab, lse = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        args = (h2, w, b, lab, lse, g, ctx.ignore_index)
        dh = xent_bwd_dh(*args) if ctx.needs_input_grad[0] else None
        dw, db = xent_bwd_dw(*args) if (ctx.needs_input_grad[1]
                                        or ctx.needs_input_grad[2]) \
            else (None, None)
        return dh, dw, db, None, None


def fused_linear_xent(hidden: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], labels: torch.Tensor,
                      ignore_index: int = -100) -> torch.Tensor:
    """Per-position loss of labels' shape through the kernels, forward
    and backward (an autograd Function). Raises on CPU tensors: the
    router (``kernels.maybe_fused_linear_xent``) sends those to
    :func:`fused_linear_xent_plain`."""
    lead = labels.shape
    n = math.prod(lead)
    h2 = hidden.reshape(n, hidden.shape[-1]).contiguous()
    lab = labels.reshape(n).to(torch.int64).contiguous()
    return _FusedLinearXent.apply(h2, weight, bias, lab,
                                  int(ignore_index)).reshape(lead)
