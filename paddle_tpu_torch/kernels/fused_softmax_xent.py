"""Fused linear projection + softmax cross-entropy: the CUDA kernels'
wrappers, their autograd Function, and the plain version.

The kernels (``csrc/fused_softmax_xent.cu``) replace the Pallas kernels
of ``paddle_tpu/kernels/fused_softmax_xent.py``: ``_fwd_kernel`` (the
streamed logsumexp and picked logit: here a partial per (row tile, vocab
split) from 3xTF32 tensor-core logits tiles, then a merge per row;
:func:`fused_xent_fwd_split_plain` is that decomposition in plain
PyTorch), and ``_backward`` with its
``_bwd_dh_kernel`` and ``_bwd_dw_kernel``: here the vocabulary runs in
chunks of :func:`bwd_chunk` columns, and for each chunk one kernel
recomputes the logits into their gradient ``D`` (an ``[N, Vc]``
scratch), one computes ``dW`` and ``db`` of the chunk from ``D``, one
adds ``D @ W_chunk`` to ``dh``; all three are 3xTF32 tensor-core
products. The source note gives the design and the bound.
:func:`fused_xent_bwd_chunked_plain` is that decomposition in plain
PyTorch, chunk for chunk.

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

Dtypes, as the JAX kernels: ``hidden``, ``weight`` and ``bias`` may be
fp32, bf16 or fp16. :func:`fused_linear_xent` reads them as fp32 (the
kernels' operands), returns the loss in fp32 and each gradient in its
input's dtype. That cast path is one autograd Function over a pair of
kernel functions (:class:`XentKernels`); the CPU tests run it with
:data:`PLAIN_KERNELS`, the kernels' plain stand-ins.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..observability import xprof as _xprof
from . import _build
from ._dtypes import cast as _cast, check as _check_dtypes

__all__ = ["fused_linear_xent", "fused_linear_xent_plain",
           "fused_xent_fwd_split_plain", "fused_xent_bwd_chunked_plain",
           "xent_fwd", "xent_bwd", "vocab_splits", "bwd_chunk",
           "XentKernels", "KERNELS", "PLAIN_KERNELS"]

# kernel launches since the last reset (kernels.reset_launch_counts): the
# forward entry launches two kernels (partials per vocab split, merge);
# the backward one dlog kernel per chunk, and one dW/db and one dh kernel
# per chunk where that gradient is needed
fwd_launches = 0
dlog_launches = 0
dw_launches = 0
dh_launches = 0

# the forward's logits tile: 128 rows x 128 vocab columns (kBM and the
# partial kernel's BN in the source)
_VOCAB_TILE = 128
_ROW_TILE = 128
# the running max's start, as the kernels keep it (never -inf)
_NEG = -1e30
# the backward's chunk: Vc columns, a multiple of the products' 128-row
# tile (kBM in the source), its [N, Vc] scratch kept to 256 MB where 128
# columns allow (bwd_chunk)
BWD_CHUNK = 2048
_CHUNK_TILE = 128
_SCRATCH_FLOATS = 64 * 2 ** 20


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


def bwd_chunk(n: int, v: int) -> int:
    """Vocabulary columns per backward chunk (``Vc``): 2048, so that at
    BERT's N = 4096 rows the chunk's logit gradient (32 MB) stays in the
    H100's 50 MB L2 between the kernel that writes it and the two that
    read it, and the dW product has 2048 / 128 x 768 / 96 = 128 tiles for
    132 SMs; fewer (down to 128) where N is so large that the [N, Vc]
    scratch would pass 256 MB; at most V rounded up to 128."""
    fit = _SCRATCH_FLOATS // max(n, 1) // _CHUNK_TILE * _CHUNK_TILE
    return max(_CHUNK_TILE, min(BWD_CHUNK, fit,
                                -(-v // _CHUNK_TILE) * _CHUNK_TILE))


def fused_xent_bwd_chunked_plain(h2: torch.Tensor, w: torch.Tensor,
                                 b: Optional[torch.Tensor],
                                 lab: torch.Tensor, lse: torch.Tensor,
                                 g: torch.Tensor, ignore_index: int = -100,
                                 chunk: Optional[int] = None):
    """The backward kernels' decomposition in plain PyTorch:
    ``(dh, dw, db)`` of ``h2`` ``[N, H]``, ``w`` ``[V, H]``, ``b``
    ``[V]`` or None, labels ``[N]``, the forward's ``lse`` and the
    upstream gradient ``g`` ``[N]``. The vocabulary runs in chunks of
    ``chunk`` (default :func:`bwd_chunk`) columns in order; each chunk's
    ``D = g (exp(logits - lse) - onehot)`` is exactly 0 on rows whose
    label is ``ignore_index`` (no compaction), gives ``dW`` and ``db``
    of its columns and is added to ``dh``. ``db`` is None without a
    bias."""
    n, hd = h2.shape
    v = w.shape[0]
    vc = chunk or bwd_chunk(n, v)
    h2, w, g = h2.float(), w.float(), g.float()
    gz = torch.where(lab != ignore_index, g, torch.zeros_like(g))[:, None]
    hot = lab.clamp(0, v - 1)[:, None]
    dh = torch.zeros_like(h2)
    dw = torch.empty_like(w)
    db = None if b is None else torch.empty(v, dtype=torch.float32,
                                            device=w.device)
    for v0 in range(0, v, vc):
        v1 = min(v, v0 + vc)
        logits = h2 @ w[v0:v1].T
        if b is not None:
            logits = logits + b[v0:v1].float()
        cols = torch.arange(v0, v1, device=h2.device)[None, :]
        d = gz * (torch.exp(logits - lse[:, None])
                  - (hot == cols).to(torch.float32))
        d = torch.where(gz != 0, d, torch.zeros_like(d))
        dw[v0:v1] = d.T @ h2
        if db is not None:
            db[v0:v1] = d.sum(dim=0)
        dh += d @ w[v0:v1]
    return dh, dw, db


@functools.lru_cache(maxsize=None)
def vocab_splits(n: int, v: int, sm_count: int) -> int:
    """Vocab splits of the forward's grid. Its (row tile, split) blocks
    run one per SM, each over ``ceil(tiles / splits)`` vocab tiles, so
    the count taken is the one whose waves end soonest:
    ``ceil(row_tiles * splits / sm_count)`` waves of ``ceil(tiles /
    splits)`` tiles; the fewest splits among equals. Cached: the search
    runs over every tile count, the same for each call at one shape."""
    row_tiles = -(-n // _ROW_TILE)
    tiles = -(-v // _VOCAB_TILE)
    return min(range(1, tiles + 1), key=lambda s: (
        -(-row_tiles * s // sm_count) * -(-tiles // s), s))


def fused_xent_fwd_split_plain(h2: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor], lab: torch.Tensor,
                               splits: int, ignore_index: int = -100
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernels' decomposition in plain PyTorch: ``(loss,
    lse)`` of ``h2`` ``[N, H]``, ``w`` ``[V, H]``, ``b`` ``[V]`` or None,
    labels ``[N]``. The vocabulary's 128-column tiles go to ``splits``
    (the kernel's :func:`vocab_splits`) contiguous splits of
    ``ceil(tiles / splits)`` tiles, the last ones possibly empty; each
    split gives every row a partial ``(max, sum of exp, picked logit)``,
    max starting at -1e30 (an empty split: (-1e30, 0, 0)), and the merge
    combines them: ``lse = M + log(sum_k s_k exp(m_k - M))``, loss ``lse
    - sum_k picked_k``, exactly 0 where the label is ``ignore_index``;
    labels are clamped into range before they pick."""
    n, v = h2.shape[0], w.shape[0]
    tiles = -(-v // _VOCAB_TILE)
    per = -(-tiles // splits)
    logits = h2.float() @ w.float().T
    if b is not None:
        logits = logits + b.float()
    hot = lab.clamp(0, v - 1)
    rows = torch.arange(n, device=h2.device)
    neg = torch.full((n,), _NEG, dtype=torch.float32, device=h2.device)
    parts = []
    for k in range(splits):
        c0 = min(v, k * per * _VOCAB_TILE)
        c1 = min(v, (k + 1) * per * _VOCAB_TILE)
        x = logits[:, c0:c1]
        m = torch.maximum(neg, x.amax(dim=1)) if c1 > c0 else neg
        inside = (hot >= c0) & (hot < c1)
        picked = torch.where(inside, logits[rows, hot],
                             torch.zeros_like(neg))
        parts.append((m, torch.exp(x - m[:, None]).sum(dim=1), picked))
    mx = torch.stack([neg] + [m for m, _, _ in parts]).amax(dim=0)
    total = sum(s * torch.exp(m - mx) for m, s, _ in parts)
    lse = mx + torch.log(total)
    picked = sum(p for _, _, p in parts)
    loss = torch.where(lab != ignore_index, lse - picked,
                       torch.zeros_like(lse))
    return loss, lse


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
    if _xprof.counting():  # the logits product (chip_smoke.xent_bounds)
        _xprof.add_kernel_flops("fused_xent_fwd", 2 * n * v * hd)
    return loss, lse


def _rows(t: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
        raise TypeError(f"{what} must be contiguous float32 [{n}]")
    return t


def xent_bwd(h2, w, b, lab, lse, g, ignore_index: int = -100,
             need_dh: bool = True, need_dw: bool = True):
    """The backward kernels: ``(dh, dw, db)`` as
    :func:`fused_xent_bwd_chunked_plain` computes them, chunk by chunk:
    the dlog kernel, then the dW/db kernel where ``need_dw``, then the dh
    kernel where ``need_dh`` (the first chunk writes ``dh``, the others
    add to it). One ``[N, Vc]`` scratch serves every chunk: the launches
    run in order on the current stream. Nothing is synchronised."""
    global dlog_launches, dw_launches, dh_launches
    n, v, hd = _checked(h2, w, b, lab)
    _rows(lse, n, "lse")
    _rows(g, n, "g")
    chunk = bwd_chunk(n, v)
    dev = h2.device
    dlog = torch.empty(n, chunk, dtype=torch.float32, device=dev)
    dh = torch.empty_like(h2) if need_dh else None
    dw = torch.empty_like(w) if need_dw else None
    db = torch.empty_like(b) if need_dw and b is not None else None
    lib = _build.library("fused_softmax_xent")
    stream = _stream(dev)
    for v0 in range(0, v, chunk):
        vc = min(chunk, v - v0)
        code = lib.fused_xent_bwd_dlog(
            h2.data_ptr(), w.data_ptr(), _ptr(b), lab.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dlog.data_ptr(), n, v, hd, v0,
            vc, chunk, int(ignore_index), stream)
        _build.check("fused_softmax_xent", code, "fused_xent_bwd_dlog")
        dlog_launches += 1
        counting = _xprof.counting()  # one product of 2 n vc hd each
        if counting:
            _xprof.add_kernel_flops("fused_xent_bwd_dlog", 2 * n * vc * hd)
        if need_dw:
            code = lib.fused_xent_bwd_dw(
                dlog.data_ptr(), h2.data_ptr(), dw.data_ptr(), _ptr(db), n,
                hd, v0, vc, chunk, stream)
            _build.check("fused_softmax_xent", code, "fused_xent_bwd_dw")
            dw_launches += 1
            if counting:
                _xprof.add_kernel_flops("fused_xent_bwd_dw",
                                        2 * n * vc * hd)
        if need_dh:
            code = lib.fused_xent_bwd_dh(
                dlog.data_ptr(), w.data_ptr(), dh.data_ptr(), n, hd, v0, vc,
                chunk, int(v0 > 0), stream)
            _build.check("fused_softmax_xent", code, "fused_xent_bwd_dh")
            dh_launches += 1
            if counting:
                _xprof.add_kernel_flops("fused_xent_bwd_dh",
                                        2 * n * vc * hd)
    return dh, dw, db


class XentKernels(NamedTuple):
    """The kernel functions the autograd Function runs, on fp32
    operands: the forward (:func:`xent_fwd`'s signature, ``(loss, lse)``)
    and the backward (:func:`xent_bwd`'s, ``(dh, dw, db)``)."""
    fwd: Callable
    bwd: Callable


def _fwd_plain(h2, w, b, lab, ignore_index: int = -100):
    with torch.no_grad():
        return fused_linear_xent_plain(h2, w, b, lab, ignore_index,
                                       return_lse=True)


def _bwd_plain(h2, w, b, lab, lse, g, ignore_index: int = -100,
               need_dh: bool = True, need_dw: bool = True):
    dh, dw, db = fused_xent_bwd_chunked_plain(h2, w, b, lab, lse, g,
                                              ignore_index)
    return (dh if need_dh else None, dw if need_dw else None,
            db if need_dw else None)


# the CUDA kernels, and their plain stand-ins (for the cast path's tests)
KERNELS = XentKernels(xent_fwd, xent_bwd)
PLAIN_KERNELS = XentKernels(_fwd_plain, _bwd_plain)


def _fp32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A bf16/fp16 operand as the contiguous fp32 copy the kernels read;
    an fp32 one (or None) as it is."""
    f = _cast(t)
    return f if f is t else f.contiguous()


class _FusedLinearXent(torch.autograd.Function):
    """The loss through ``kernels``, forward and backward. The one cast
    path of every dtype: hidden, weight and bias read as fp32, the loss
    in fp32, each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, h2, w, b, lab, ignore_index, kernels):
        hf, wf, bf = _fp32(h2), _fp32(w), _fp32(b)
        loss, lse = kernels.fwd(hf, wf, bf, lab, ignore_index)
        ctx.save_for_backward(hf, wf, bf, lab, lse)
        ctx.ignore_index = ignore_index
        ctx.kernels = kernels
        ctx.dtypes = (h2.dtype, w.dtype, None if b is None else b.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        h2, w, b, lab, lse = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        need_dw = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        grads = ctx.kernels.bwd(h2, w, b, lab, lse, g, ctx.ignore_index,
                                ctx.needs_input_grad[0], need_dw)
        dh, dw, db = (_cast(x, dt) for x, dt in zip(grads, ctx.dtypes))
        return dh, dw, db, None, None, None


def fused_linear_xent(hidden: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor], labels: torch.Tensor,
                      ignore_index: int = -100,
                      kernels: XentKernels = KERNELS) -> torch.Tensor:
    """Per-position fp32 loss of labels' shape through the kernels,
    forward and backward (an autograd Function); hidden, weight and bias
    in fp32, bf16 or fp16 (see the module note). Raises on CPU tensors:
    the router (``kernels.maybe_fused_linear_xent``) sends those to
    :func:`fused_linear_xent_plain`. ``kernels`` is what the Function
    runs; the CPU tests pass :data:`PLAIN_KERNELS`."""
    _check_dtypes("fused softmax-xent", hidden=hidden, weight=weight,
                  bias=bias)
    lead = labels.shape
    n = math.prod(lead)
    h2 = hidden.reshape(n, hidden.shape[-1]).contiguous()
    lab = labels.reshape(n).to(torch.int64).contiguous()
    return _FusedLinearXent.apply(h2, weight, bias, lab, int(ignore_index),
                                  kernels).reshape(lead)
