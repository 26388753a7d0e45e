"""Flash attention: the CUDA kernels' wrappers, their autograd Function,
and the plain version.

The kernels (``csrc/flash_attention.cu``) replace the Pallas kernels of
``paddle_tpu/kernels/flash_attention.py``: ``_flash_fwd_kernel`` (the
forward, writing ``out`` and the row logsumexp ``lse``),
``_bwd_fused_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (the
recompute backward). The source note gives the design and the bound.

Semantics are the JAX package's ``flash_attention``:
``dropout(softmax(q k^T * scale + kv_bias [+ causal mask])) v`` with

- q/k/v ``[B, H, T, D]``, or ``[B, T, H, D]`` with ``bthd=True``; the
  kernels read either layout through strides, without a copy;
- causal masking bottom-right aligned (query i sees keys
  ``[0, i + Tk - Tq]``);
- ``kv_bias`` ``[B, Tk]`` additive, with a zero gradient;
- dropout inside the kernels: the keep mask is the murmur3-finalizer
  hash of (seed, b * H + h, q_pos, k_pos), bit for bit the JAX
  package's ``_dropout_keep``, so both packages drop the same entries
  for the same seed; ``seed`` is a one-element int32 tensor the kernels
  read on the device;
- a masked entry has probability exactly 0.

The backward takes the fused kernel when both sequences fit its tile
(:func:`backward_route`): the JAX rule (fused when the padded Tq and Tk
each equal one tile) with the port's tile, 128 rows at D <= 64 and 64 at
D <= 128, what a Hopper block's 227 KB of shared memory holds of Q, K, V,
dO and a dQ accumulator. Longer sequences, and every sequence at D > 128,
take the dq and dkv kernels (the dkv kernel on the tensor cores in
3xTF32). ``delta = rowsum(dO * out)`` is a torch reduction, as it is an
XLA op in the JAX package.

The kernels are built for the head dims in ``HEAD_DIMS`` (every multiple
of 16 up to 128, and 256, 384 and 512). A head dim above 512 runs as
slices of one of them (:func:`head_dim_plan`): the grid gains a slice
axis, each block forms its scores over the whole head dim and writes its
own slice of the output or gradient. :func:`flash_attention` zero-pads
any other head dim to the kernels' (:func:`kernel_head_dim`) and slices
the output: zero columns change neither q.k nor the output, and the
scale stays ``1/sqrt`` of the unpadded dim. The kernel entry points
themselves take fp32 CUDA tensors whose head dim is a kernel head dim,
contiguous in that dim, with the other strides multiples of 4 floats and
16-byte aligned data; anything else raises.

Dtypes, as the JAX kernels: q, k and v may be fp32, bf16 or fp16, and
``kv_bias`` too; the kernels read them as fp32 (:func:`flash_attention`
casts on the way in), ``out`` comes back in q's dtype, each gradient in
its input's dtype, ``lse`` in fp32. The cast path is one autograd
Function over a set of kernel functions (:class:`FlashKernels`); the
CPU tests run it with :data:`PLAIN_KERNELS`, the kernels' plain
stand-ins, in the CUDA kernels' place.

:func:`flash_attention_with_lse` is the JAX package's entry of the same
name: ``(out, lse)``, both differentiable, no dropout and no bias. It
runs the same kernels; lse's cotangent folds into the backward's delta
(``delta = rowsum(dO * out) - dlse``), so it needs no kernel of its own.
:func:`flash_attention_with_lse_plain` is its plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..observability import xprof as _xprof
from . import _build
from . import _dtypes as _dt
from ._dtypes import cast as _cast, check as _check_dtypes

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_with_lse", "flash_attention_with_lse_plain",
           "flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_plain", "flash_bwd_plain", "FlashKernels", "KERNELS",
           "PLAIN_KERNELS", "backward_route", "fused_rows",
           "kernel_head_dim", "head_dim_plan", "dropout_keep_mask",
           "dropout_threshold", "HEAD_DIMS"]

NEG_INF = -1e30
# the head dims the kernels are instantiated for (DISPATCH_D in the source)
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 256, 384, 512)
# the widest head-dim slice one block holds (slices() in the source)
MAX_SLICE = HEAD_DIMS[-1]

# kernel launches since the last reset (kernels.reset_launch_counts)
fwd_launches = 0
fused_launches = 0
dq_launches = 0
dkv_launches = 0

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def head_dim_plan(d: int) -> Tuple[int, int]:
    """``(slices, width)`` the kernels run a head dim ``d`` as: one slice
    of the smallest of ``HEAD_DIMS`` >= d up to 512; above,
    ``ceil(d / 512)`` slices of the smallest of ``HEAD_DIMS`` that holds
    ``d / slices`` (640 runs as 2 x 384, 1024 as 2 x 512)."""
    if d <= 0:
        raise ValueError(f"flash attention head dim must be positive, "
                         f"got {d}")
    n = -(-d // MAX_SLICE)
    part = -(-d // n)
    return n, next(kd for kd in HEAD_DIMS if kd >= part)


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at (the wrapper
    zero-pads up to it): slices x width of :func:`head_dim_plan`."""
    n, width = head_dim_plan(d)
    return n * width


def fused_rows(d: int) -> int:
    """Sequence length up to which one (batch, head) fits the fused
    backward kernel whole (``fused_rows()`` in the CUDA source), at the
    kernels' head dim for ``d``: 128 up to 64, 64 up to 128, else 0."""
    kd = kernel_head_dim(d)
    return 128 if kd <= 64 else 64 if kd <= 128 else 0


def backward_route(tq: int, tk: int, d: int) -> str:
    """``"fused"`` when both sequences fit the fused kernel's tile, else
    ``"split"`` (the dq kernel and the dkv kernel). The JAX package's
    rule (``_flash_backward``: fused when ``tq_p == bq and tk_p == bk``,
    i.e. both lengths within one tile) with the port's tile."""
    n = fused_rows(d)
    return "fused" if tq <= n and tk <= n else "split"


def dropout_threshold(dropout_p: float) -> int:
    """The keep threshold on 32 random bits, as the JAX kernel computes
    it on the host: ``min(int(p * 2**32), 2**32 - 1)``."""
    return min(int(dropout_p * 4294967296.0), 4294967295)


# --- the dropout hash on int64 tensors, wrapping at 32 bits ----------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    # x * c mod 2**32 without int64 overflow: split c into 16-bit halves
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_keep_mask(seed: torch.Tensor, b: int, h: int, tq: int, tk: int,
                      dropout_p: float) -> torch.Tensor:
    """Bool keep mask ``[B, H, Tq, Tk]`` on the seed's device: the JAX
    package's ``_dropout_keep`` over (seed, b * H + h, q_pos, k_pos)."""
    dev = seed.device
    s = seed.reshape(-1)[0].to(torch.int64) & _M32
    g = torch.arange(b * h, device=dev, dtype=torch.int64)
    hh = _fmix32(s ^ _fmix32((g + _GOLDEN) & _M32))
    q_pos = torch.arange(tq, device=dev, dtype=torch.int64)
    u = _fmix32((q_pos[None, :] + hh[:, None]) & _M32)
    k_mix = _mul32(torch.arange(tk, device=dev, dtype=torch.int64), _GOLDEN)
    bits = _fmix32(u[:, :, None] ^ k_mix[None, None, :])
    return (bits >= dropout_threshold(dropout_p)).reshape(b, h, tq, tk)


def _plain(q, k, v, causal, scale, dropout_p, seed, kv_bias, bthd):
    """(out, lse) in plain PyTorch, both differentiable: materialised
    scores in fp32, the kernels' masks and dropout hash; out in q's
    dtype and layout, lse ``[B, H, Tq]`` fp32."""
    if dropout_p > 0.0 and seed is None:
        raise ValueError("flash_attention: dropout_p > 0 requires a seed")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if bthd:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    # the JAX forward scales q before the product
    s = torch.einsum("bhqd,bhkd->bhqk", _dt.wide(q) * scale, _dt.wide(k))
    if kv_bias is not None:
        s = s + _dt.wide(kv_bias.detach())[:, None, None, :]
    valid = None
    if causal:
        q_pos = torch.arange(tq, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        valid = q_pos + (tk - tq) >= k_pos
        s = s.masked_fill(~valid, NEG_INF)
    # d lse / ds = p whatever m is, so m need not carry a gradient
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(s - m)
    if valid is not None:
        e = e.masked_fill(~valid, 0.0)
    l = e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = e / l
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, b, h, tq, tk, dropout_p)
        p = torch.where(keep, p, torch.zeros_like(p)) / (1.0 - dropout_p)
    out = torch.einsum("bhqk,bhkd->bhqd", p, _dt.wide(v)).to(q.dtype)
    if bthd:
        out = out.transpose(1, 2)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_p: float = 0.0,
                          seed: Optional[torch.Tensor] = None,
                          kv_bias: Optional[torch.Tensor] = None,
                          bthd: bool = False, return_lse: bool = False):
    """The kernels' plain PyTorch version: materialised scores, the same
    masks and dropout hash, autograd for the gradient (``kv_bias`` gets
    none). The oracle of the kernels, and their stand-in for CPU
    tensors. Computes in fp32 from any input dtype; the output in q's
    dtype. With ``return_lse`` also returns ``lse`` ``[B, H, Tq]`` fp32,
    detached."""
    out, lse = _plain(q, k, v, causal, scale, dropout_p, seed, kv_bias,
                      bthd)
    return (out, lse.detach()) if return_lse else out


def flash_attention_with_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, causal: bool = False,
                                   scale: Optional[float] = None,
                                   bthd: bool = False):
    """:func:`flash_attention_with_lse` in plain PyTorch: ``(out, lse)``
    with both differentiable through autograd (``lse = m + log(sum
    exp(s - m))``, whose gradient is p)."""
    return _plain(q, k, v, causal, scale, 0.0, None, None, bthd)


def flash_fwd_plain(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed=None, kv_bias=None, bthd: bool = False):
    """The forward kernel's plain stand-in: ``(out, lse)`` as
    :func:`flash_fwd` returns them, on any device."""
    with torch.no_grad():
        return flash_attention_plain(q, k, v, causal, scale, dropout_p,
                                     seed, kv_bias, bthd, return_lse=True)


def flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed=None, kv_bias=None, bthd: bool = False):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv)``
    from the saved ``lse`` and ``delta`` (``[B, H, Tq]``), as the dq, dkv
    and fused kernels compute them: ``p = exp(q.k scale + bias - lse)``
    (0 where masked), ``dS = p (dP keep / (1 - p) - delta) scale``,
    ``dq = dS k``, ``dk = dS^T q``, ``dv = (p keep / (1 - p))^T dO``.
    Their stand-in for CPU tensors in the cast path's tests."""
    if dropout_p > 0.0 and seed is None:
        raise ValueError("flash_attention: dropout_p > 0 requires a seed")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if bthd:
        q, k, v, dout = (t.transpose(1, 2) for t in (q, k, v, dout))
    q, k, v, dout = (_dt.wide(t) for t in (q, k, v, dout))
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if kv_bias is not None:
        s = s + _dt.wide(kv_bias)[:, None, None, :]
    p = torch.exp(s - _dt.wide(lse)[..., None])
    if causal:
        q_pos = torch.arange(tq, device=q.device)[:, None]
        k_pos = torch.arange(tk, device=q.device)[None, :]
        p = p.masked_fill(q_pos + (tk - tq) < k_pos, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    pv = p
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, b, h, tq, tk, dropout_p)
        pv = torch.where(keep, p, torch.zeros_like(p)) / (1.0 - dropout_p)
        dp = torch.where(keep, dp, torch.zeros_like(dp)) / (1.0 - dropout_p)
    ds = p * (dp - _dt.wide(delta)[..., None]) * scale
    grads = (torch.einsum("bhqk,bhkd->bhqd", ds, k),
             torch.einsum("bhqk,bhqd->bhkd", ds, q),
             torch.einsum("bhqk,bhqd->bhkd", pv, dout))
    return tuple(g.transpose(1, 2) if bthd else g for g in grads)


# --- the CUDA kernels ------------------------------------------------------

def _bth_strides(t: torch.Tensor, bthd: bool) -> Tuple[int, int, int]:
    """(batch, time, head) strides of a [B,T,H,D] or [B,H,T,D] tensor."""
    if bthd:
        return t.stride(0), t.stride(1), t.stride(2)
    return t.stride(0), t.stride(2), t.stride(1)


def _kernel_readable(t: torch.Tensor) -> bool:
    """True when the kernels' 16-byte row loads can read ``t`` in place:
    contiguous in the head dim, the other strides multiples of 4 floats,
    16-byte aligned data."""
    return (t.stride(3) == 1 and not any(s % 4 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check_operand(t: torch.Tensor, what: str, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors "
                         f"({what} is on {t.device})")
    if t.device != device or t.dtype != torch.float32 or t.ndim != 4:
        raise TypeError(f"flash attention kernel takes 4-D float32 "
                        f"tensors on one device ({what}: {t.dtype}, "
                        f"{t.ndim}-D on {t.device})")
    if not _kernel_readable(t):
        raise ValueError(f"flash attention kernel needs {what} contiguous "
                         f"in the head dim, other strides multiples of 4 "
                         f"and 16-byte aligned data (strides "
                         f"{t.stride()})")


class _Call:
    """Checked operands of one kernel call and its host-side arguments:
    the dims array (B, H, Tq, Tk, D, then the (batch, time, head) strides
    of q, k, v, out, dO, dq, dk, dv) and the scalars."""

    ROLES = ("q", "k", "v", "out", "dout", "dq", "dk", "dv")

    def entries(self) -> int:
        return score_entries(self.b, self.h, self.tq, self.tk, self.causal)

    def __init__(self, q, k, v, causal, scale, dropout_p, seed, kv_bias,
                 bthd):
        if dropout_p > 0.0 and seed is None:
            raise ValueError("flash_attention: dropout_p > 0 requires a "
                             "seed")
        self.device = dev = q.device
        for name, t in (("q", q), ("k", k), ("v", v)):
            _check_operand(t, name, dev)
        if bthd:
            self.b, self.tq, self.h, self.d = q.shape
            self.tk = k.shape[1]
        else:
            self.b, self.h, self.tq, self.d = q.shape
            self.tk = k.shape[2]
        if k.shape != v.shape or k.shape[0] != self.b \
                or k.shape[3] != self.d \
                or k.shape[2 if bthd else 1] != self.h:
            raise ValueError(f"flash attention shapes disagree: q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                             f"{tuple(v.shape)}")
        if kernel_head_dim(self.d) != self.d:
            raise ValueError(f"flash attention kernels are built for head "
                             f"dims {HEAD_DIMS} and slices of them above "
                             f"{MAX_SLICE}, got {self.d} (the "
                             f"flash_attention wrapper pads the others)")
        if kv_bias is not None and (
                kv_bias.shape != (self.b, self.tk) or kv_bias.device != dev
                or kv_bias.dtype != torch.float32
                or not kv_bias.is_contiguous()):
            raise TypeError(f"kv_bias must be contiguous float32 "
                            f"[{self.b}, {self.tk}] on the query's device")
        self.dropout = dropout_p > 0.0
        if self.dropout and (seed.device != dev or seed.dtype != torch.int32
                             or seed.numel() < 1):
            raise TypeError("seed must be an int32 tensor on the query's "
                            "device")
        self.bthd = bthd
        self.seed = seed if self.dropout else None
        self.kv_bias = kv_bias
        self.scale = float(1.0 / math.sqrt(self.d) if scale is None
                           else scale)
        self.causal = int(bool(causal))
        self.keep_prob = float(1.0 - dropout_p) if self.dropout else 1.0
        self.threshold = dropout_threshold(dropout_p) if self.dropout else 0
        self.strides = {"q": _bth_strides(q, bthd), "k": _bth_strides(k, bthd),
                        "v": _bth_strides(v, bthd)}
        self.stream = torch.cuda.current_stream(dev).cuda_stream

    def add(self, role: str, t: torch.Tensor) -> torch.Tensor:
        _check_operand(t, role, self.device)
        self.strides[role] = _bth_strides(t, self.bthd)
        return t

    def rows(self, t: torch.Tensor, what: str) -> torch.Tensor:
        """A [B, H, Tq] fp32 row statistic (lse, delta), contiguous."""
        if t.shape != (self.b, self.h, self.tq) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != self.device:
            raise TypeError(f"{what} must be contiguous float32 "
                            f"[{self.b}, {self.h}, {self.tq}] on the card")
        return t

    def args(self):
        dims = [self.b, self.h, self.tq, self.tk, self.d]
        for role in self.ROLES:
            dims.extend(self.strides.get(role, (0, 0, 0)))
        self._dims = (ctypes.c_longlong * len(dims))(*dims)
        bias = None if self.kv_bias is None else self.kv_bias.data_ptr()
        seed = None if self.seed is None else self.seed.data_ptr()
        return (bias, seed), (ctypes.addressof(self._dims), self.scale,
                              self.causal, self.keep_prob, self.threshold,
                              self.stream)


def score_entries(b: int, h: int, tq: int, tk: int, causal: bool) -> int:
    """The score entries a flash call's mask keeps (causal: the lower
    triangle aligned to the last key), over which its products run."""
    if not causal:
        return b * h * tq * tk
    return b * h * sum(min(tk, max(0, i + tk - tq + 1)) for i in range(tq))


def _count_flops(name: str, call: "_Call", products: int) -> None:
    """Adds a launch's work to the program card counting FLOPs, if any
    (``observability.xprof``: the counter cannot see a ``ctypes``
    launch): ``products`` matrix products over the score entries the
    mask keeps, 2 x entries x D each (``chip_smoke.flash_bounds``)."""
    if _xprof.counting():
        _xprof.add_kernel_flops(name, 2 * products * call.entries()
                                * call.d)


def flash_fwd(q, k, v, causal: bool = False, scale: Optional[float] = None,
              dropout_p: float = 0.0, seed=None, kv_bias=None,
              bthd: bool = False):
    """The forward kernel: returns ``(out, lse)``, ``out`` in q's layout
    and ``lse`` ``[B, H, Tq]`` fp32."""
    global fwd_launches
    call = _Call(q, k, v, causal, scale, dropout_p, seed, kv_bias, bthd)
    out = call.add("out", torch.empty_like(q))
    lse = torch.empty(call.b, call.h, call.tq, dtype=torch.float32,
                      device=q.device)
    (bias, seed_p), tail = call.args()
    code = _build.library("flash_attention").flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias, seed_p,
        out.data_ptr(), lse.data_ptr(), *tail)
    _build.check("flash_attention", code, "flash_attention_fwd")
    fwd_launches += 1
    _count_flops("flash_attention_fwd", call, 2)  # QK^T, PV
    return out, lse


def _bwd_call(q, k, v, dout, lse, delta, causal, scale, dropout_p, seed,
              kv_bias, bthd):
    call = _Call(q, k, v, causal, scale, dropout_p, seed, kv_bias, bthd)
    call.add("dout", dout)
    if dout.shape != q.shape:
        raise ValueError(f"dO shape {tuple(dout.shape)} != q shape "
                         f"{tuple(q.shape)}")
    call.rows(lse, "lse")
    call.rows(delta, "delta")
    return call


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = False,
                 scale: Optional[float] = None, dropout_p: float = 0.0,
                 seed=None, kv_bias=None, bthd: bool = False):
    """The dq kernel (query tiles scanning keys). Returns dq."""
    global dq_launches
    call = _bwd_call(q, k, v, dout, lse, delta, causal, scale, dropout_p,
                     seed, kv_bias, bthd)
    dq = call.add("dq", torch.empty_like(q))
    (bias, seed_p), tail = call.args()
    code = _build.library("flash_attention").flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), bias, seed_p, dq.data_ptr(),
        *tail)
    _build.check("flash_attention", code, "flash_attention_bwd_dq")
    dq_launches += 1
    _count_flops("flash_attention_bwd_dq", call, 3)  # S, dP, dQ
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool = False,
                  scale: Optional[float] = None, dropout_p: float = 0.0,
                  seed=None, kv_bias=None, bthd: bool = False):
    """The dkv kernel (key tiles scanning queries). Returns (dk, dv)."""
    global dkv_launches
    call = _bwd_call(q, k, v, dout, lse, delta, causal, scale, dropout_p,
                     seed, kv_bias, bthd)
    dk = call.add("dk", torch.empty_like(k))
    dv = call.add("dv", torch.empty_like(v))
    (bias, seed_p), tail = call.args()
    code = _build.library("flash_attention").flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), bias, seed_p, dk.data_ptr(),
        dv.data_ptr(), *tail)
    _build.check("flash_attention", code, "flash_attention_bwd_dkv")
    dkv_launches += 1
    _count_flops("flash_attention_bwd_dkv", call, 4)  # S, dP, dV, dK
    return dk, dv


def flash_bwd_fused(q, k, v, dout, lse, delta, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed=None, kv_bias=None, bthd: bool = False):
    """The fused backward kernel, for sequences that fit its tile
    (:func:`backward_route` is ``"fused"``). Returns (dq, dk, dv)."""
    global fused_launches
    call = _bwd_call(q, k, v, dout, lse, delta, causal, scale, dropout_p,
                     seed, kv_bias, bthd)
    if backward_route(call.tq, call.tk, call.d) != "fused":
        raise ValueError(f"sequences {call.tq}/{call.tk} exceed the fused "
                         f"backward's {fused_rows(call.d)} rows")
    dq = call.add("dq", torch.empty_like(q))
    dk = call.add("dk", torch.empty_like(k))
    dv = call.add("dv", torch.empty_like(v))
    (bias, seed_p), tail = call.args()
    code = _build.library("flash_attention").flash_attention_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), bias, seed_p, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *tail)
    _build.check("flash_attention", code, "flash_attention_bwd_fused")
    fused_launches += 1
    _count_flops("flash_attention_bwd_fused", call, 5)  # S, dP, dV, dK, dQ
    return dq, dk, dv


class FlashKernels(NamedTuple):
    """The kernel functions the autograd Function runs: the forward
    (``(out, lse)``), the dq kernel, the dkv kernel (``(dk, dv)``) and
    the fused backward (``(dq, dk, dv)``), each with the signature of
    :func:`flash_fwd` / :func:`flash_bwd_dq` and on fp32 operands."""
    fwd: Callable
    dq: Callable
    dkv: Callable
    fused: Callable


def _bwd_dq_plain(*args, **kw):
    return flash_bwd_plain(*args, **kw)[0]


def _bwd_dkv_plain(*args, **kw):
    return flash_bwd_plain(*args, **kw)[1:]


# the CUDA kernels, and their plain stand-ins (for the cast path's tests)
KERNELS = FlashKernels(flash_fwd, flash_bwd_dq, flash_bwd_dkv,
                       flash_bwd_fused)
PLAIN_KERNELS = FlashKernels(flash_fwd_plain, _bwd_dq_plain, _bwd_dkv_plain,
                             flash_bwd_plain)


def _fp32(t: torch.Tensor) -> torch.Tensor:
    """A bf16/fp16 operand as the fp32 copy the kernels read (contiguous
    where its strides would not be readable); an fp32 one as it is."""
    f = _cast(t)
    return f if f is t or _kernel_readable(f) else f.contiguous()


class _FlashAttention(torch.autograd.Function):
    """``(out, lse)`` through ``kernels``, forward and backward, both
    outputs differentiable. The one cast path of every dtype: q, k, v and
    ``kv_bias`` read as fp32, out returned in q's dtype, lse in fp32, and
    each gradient in its input's dtype. lse's cotangent folds into delta
    (``delta = rowsum(dO * out) - dlse``), as the JAX package's
    ``_bwd_lse`` does; an output that gets no cotangent contributes
    nothing."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, seed, causal, scale, dropout_p,
                bthd, kernels):
        qf, kf, vf = (_fp32(t) for t in (q, k, v))
        bias = _cast(kv_bias)
        bias = bias if bias is kv_bias else bias.contiguous()
        out, lse = kernels.fwd(qf, kf, vf, causal, scale, dropout_p, seed,
                               bias, bthd)
        ctx.save_for_backward(qf, kf, vf, out, lse, bias, seed)
        ctx.opts = (causal, scale, dropout_p, bthd, kernels)
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        ctx.set_materialize_grads(False)
        return _cast(out, q.dtype), lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, kv_bias, seed = ctx.saved_tensors
        causal, scale, dropout_p, bthd, kernels = ctx.opts
        dout = torch.zeros_like(out) if dout is None else _fp32(dout)
        # dO as autograd hands it over, in a layout the kernels read
        if not _kernel_readable(dout):
            dout = dout.contiguous()
        delta = (dout * out).sum(dim=-1)
        delta = delta.transpose(1, 2) if bthd else delta
        if dlse is not None:
            delta = delta - _cast(dlse)
        delta = delta.contiguous()
        args = (q, k, v, dout, lse, delta, causal, scale, dropout_p, seed,
                kv_bias, bthd)
        tq, d = lse.shape[2], q.shape[3]
        tk = k.shape[1] if bthd else k.shape[2]
        if backward_route(tq, tk, d) == "fused":
            dq, dk, dv = kernels.fused(*args)
        else:
            dq = kernels.dq(*args)
            dk, dv = kernels.dkv(*args)
        dq, dk, dv = (_cast(g, dt) for g, dt in zip((dq, dk, dv),
                                                     ctx.dtypes))
        return dq, dk, dv, None, None, None, None, None, None, None


def _flash(q, k, v, causal, scale, dropout_p, seed, kv_bias, bthd,
           kernels) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` through the Function, a head dim the kernels do not
    run as it is zero-padded to :func:`kernel_head_dim` around it
    (autograd slices the gradients back), with the scale of the unpadded
    dim."""
    _check_dtypes("flash attention", q=q, k=k, v=v, kv_bias=kv_bias)
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    if kd != d:
        if scale is None:
            scale = 1.0 / math.sqrt(d)
        q, k, v = (torch.nn.functional.pad(t, (0, kd - d))
                   for t in (q, k, v))
    out, lse = _FlashAttention.apply(q, k, v, kv_bias, seed, causal, scale,
                                     float(dropout_p), bthd, kernels)
    return (out if kd == d else out[..., :d]), lse


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None, dropout_p: float = 0.0,
                    seed: Optional[torch.Tensor] = None,
                    kv_bias: Optional[torch.Tensor] = None,
                    bthd: bool = False,
                    kernels: FlashKernels = KERNELS) -> torch.Tensor:
    """Flash attention on CUDA tensors through the kernels, forward and
    backward (an autograd Function), in fp32, bf16 or fp16 (see the
    module note). Raises on CPU tensors: the router
    (``kernels.maybe_flash_attention``) sends those to
    :func:`flash_attention_plain`. A head dim the kernels do not run as
    it is is zero-padded to :func:`kernel_head_dim`. ``kernels`` is what
    the Function runs; the CPU tests pass :data:`PLAIN_KERNELS`."""
    return _flash(q, k, v, causal, scale, dropout_p, seed, kv_bias, bthd,
                  kernels)[0]


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             scale: Optional[float] = None,
                             bthd: bool = False,
                             kernels: FlashKernels = KERNELS
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``flash_attention_with_lse``: ``(out, lse)``
    with both differentiable, the building block for combining partial
    attention over sharded K/V (ring attention). No dropout and no bias.
    The same kernels and cast path as :func:`flash_attention`; lse
    ``[B, H, Tq]`` fp32. Raises on CPU tensors: the router
    (``kernels.maybe_flash_attention_with_lse``) sends those to
    :func:`flash_attention_with_lse_plain`."""
    return _flash(q, k, v, causal, scale, 0.0, None, None, bthd, kernels)
