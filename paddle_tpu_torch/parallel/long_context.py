"""Long-context attention: ring attention and Ulysses sequence
parallelism.

Counterpart of ``paddle_tpu.parallel.long_context``, the same names,
arguments and routes. The JAX functions take the global ``[B, H, T, D]``
arrays sharded on T over a mesh axis and run inside ``shard_map``; here
each rank is a process, so each rank passes ITS shard ``[B, H, T/n, D]``
(block r of the sequence on the rank of index r along ``axis``) and gets
its shard of the output. Gradients flow through both (the collectives are
autograd Functions).

- **Ring attention**: Q stays, K/V travel one hop around the ring per
  step (``collective.ppermute``; K and V ride one packed tensor, so the
  backward's hops pair up on every rank). Two per-hop routes, as in JAX:
  the online-softmax fold in plain PyTorch, and the flash route, where
  each hop is ``flash_attention_with_lse`` (B8 over the flash kernels
  B1/B2 on the card; its plain version on the CPU), ``(o_i, lse_i)``
  merged exactly as ``out = sum_i exp(lse_i - m) o_i / sum_i exp(lse_i -
  m)``; both outputs carry gradients (lse's cotangent goes into the
  kernel's delta). Causal routing per hop is decided on the host from
  ``(rank, step)``: K/V from this rank (the diagonal) run the kernel's
  causal mode, K/V from earlier ranks attend fully, later ones are
  skipped and launch nothing. So rank r of a causal ring launches r full
  hops and one causal hop.
- **Ulysses**: ``all_to_all`` from sequence-sharded to head-sharded
  ``[B, H/n, T, D]``, local attention over the whole sequence (the flash
  kernel, or the plain attention), and back. Needs ``num_heads % n == 0``.

The gate (``use_flash=None``): the flash kernel on CUDA whenever
``head_dim % 8 == 0``, whatever ``flash_attention_min_seq`` says (O(T)
memory is the point of these paths); the CPU takes the plain versions
(``use_flash=True`` on the CPU runs the kernel's plain version per hop).
``interpret`` is accepted for the JAX signature and changes nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collective as _c
from .mesh import Mesh

__all__ = ["ring_attention", "ulysses_attention"]

_NEG_INF = -1e30


def _default_use_flash(q: torch.Tensor) -> bool:
    return q.is_cuda and q.shape[-1] % 8 == 0


def _ring_setup(mesh: Mesh, axis: str):
    pg = mesh.group(axis)
    n = mesh.shape[axis]
    idx = mesh.axis_index(axis) if pg is not None else 0
    perm = [(i, (i + 1) % n) for i in range(n)]
    return pg, n, idx, perm


def _shift(kv: torch.Tensor, perm, pg) -> torch.Tensor:
    return kv if pg is None else _c.ppermute(kv, perm, group=pg)


def _ring_fold(q, k, v, mesh: Mesh, axis: str, causal: bool,
               scale: Optional[float]) -> torch.Tensor:
    """The online-softmax fold of every hop (the JAX XLA route)."""
    pg, n, idx, perm = _ring_setup(mesh, axis)
    t_local, d = q.shape[2], q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.float() * scale
    rows = torch.arange(t_local, device=q.device)
    q_pos = (idx * t_local + rows)[:, None]
    b, h = q.shape[:2]
    acc = torch.zeros((b, h, t_local, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, h, t_local, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros_like(m)
    kv = torch.stack([k, v])
    for step in range(n):
        if step:
            kv = _shift(kv, perm, pg)
        src = (idx - step) % n
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kv[0].float())
        if causal:
            k_pos = (src * t_local + rows)[None, :]
            s = torch.where(q_pos >= k_pos, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         kv[1].float())
        m = m_new
    return (acc / torch.clamp(l_sum, min=1e-30)).to(q.dtype)


class _Tie(torch.autograd.Function):
    """``x`` itself, with ``others`` as inputs whose gradient is zero: a
    rank's skipped hops still take part in the backward, so every rank
    runs the same reverse shifts (collectives match by order)."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=dv)
                            for s, d, dv in ctx.shapes)


def _ring_flash(q, k, v, mesh: Mesh, axis: str, causal: bool,
                scale: Optional[float]) -> torch.Tensor:
    """Each hop through ``flash_attention_with_lse`` (see the module
    note), skipped hops launching nothing."""
    from .. import kernels
    pg, n, idx, perm = _ring_setup(mesh, axis)
    b, h, t_local, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    acc = m = l_sum = None
    skipped = []
    kv = torch.stack([k, v])
    for step in range(n):
        if step:
            kv = _shift(kv, perm, pg)
        src = (idx - step) % n
        if causal and src > idx:
            skipped.append(kv)  # a later rank's keys: nothing to attend
            continue
        o, lse = kernels.maybe_flash_attention_with_lse(
            q, kv[0], kv[1], causal=causal and src == idx, scale=scale)
        o = o.float()
        lse_e = lse.unsqueeze(-1)
        if acc is None:
            acc, m, l_sum = o, lse_e, torch.ones_like(lse_e)
            continue
        m_new = torch.maximum(m, lse_e)
        w_prev = torch.exp(m - m_new)
        w_cur = torch.exp(lse_e - m_new)
        acc = acc * w_prev + o * w_cur
        l_sum = l_sum * w_prev + w_cur
        m = m_new
    out = (acc / torch.clamp(l_sum, min=1e-30)).to(q.dtype)
    return _Tie.apply(out, *skipped) if skipped else out


def ring_attention(q, k, v, mesh: Mesh, axis: str = "sp",
                   causal: bool = False, scale: Optional[float] = None,
                   use_flash: Optional[bool] = None,
                   interpret: bool = False) -> torch.Tensor:
    """Context-parallel attention over this rank's ``[B, H, T/n, D]``
    shards of q, k and v; returns this rank's output shard. ``use_flash``
    picks the per-hop route (see the module note)."""
    if use_flash is None:
        use_flash = _default_use_flash(q)
    fn = _ring_flash if use_flash else _ring_fold
    return fn(q, k, v, mesh, axis, causal, scale)


def ulysses_attention(q, k, v, mesh: Mesh, axis: str = "sp",
                      causal: bool = False, scale: Optional[float] = None,
                      use_flash: Optional[bool] = None,
                      interpret: bool = False) -> torch.Tensor:
    """Ulysses sequence parallelism over this rank's ``[B, H, T/n, D]``
    shards; needs ``num_heads % mesh.shape[axis] == 0``."""
    n = mesh.shape[axis]
    if q.shape[1] % n != 0:
        raise ValueError(
            f"num_heads={q.shape[1]} not divisible by sp={n}; "
            "use ring_attention")
    if use_flash is None:
        use_flash = _default_use_flash(q)
    pg = mesh.group(axis)

    def seq_to_head(x):
        return x if pg is None else _c.all_to_all(x, 1, 2, group=pg)

    def head_to_seq(x):
        return x if pg is None else _c.all_to_all(x, 2, 1, group=pg)

    qh, kh, vh = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    if use_flash:
        from ..kernels import flash_attention as fa
        impl = fa.flash_attention if qh.is_cuda else fa.flash_attention_plain
        out = impl(qh, kh, vh, causal=causal, scale=scale)
    else:
        from ..ops.attention import scaled_dot_product_attention
        out = scaled_dot_product_attention(qh, kh, vh, causal=causal,
                                           scale=scale)
    return head_to_seq(out)
