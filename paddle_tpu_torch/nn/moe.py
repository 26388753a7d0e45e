"""Mixture-of-Experts layer with expert parallelism.

Counterpart of ``paddle_tpu.nn.layers.moe``: ``MoELayer`` (a top-k gated
FFN, Switch/GShard style) and ``moe_param_rule`` (the ``param_rule`` that
splits the stacked expert weights over an ``ep`` mesh axis).

**The semantics** are the JAX layer's, which the tests hold:

- The gate's softmax runs in fp32 and picks each token's ``top_k``
  experts, ties to the lower index (the total order of ``ops.search``'s
  ``topk``, as ``jax.lax.top_k``).
- An expert takes at most ``capacity = ceil(capacity_factor * N * k /
  E)`` tokens (``N`` the tokens of the batch). The slots fill in
  priority order, k-major: every token's first choice in token order,
  then every second choice, and so on. A choice past the capacity is
  dropped from both the dispatch and the combine.
- Each expert is ``act(x W_in + b_in) W_out + b_out`` over its ``[C, D]``
  slots, in ``x.dtype``; the dispatch and the combine (weighted by the
  chosen gate probabilities) run in fp32.
- ``aux_loss``, the GShard load-balance term (``E`` times the sum over
  experts of the top-1 fraction times the mean gate probability), is a
  buffer the forward rewrites IN PLACE, so a captured step writes it at
  the address it read. The JAX layer's traced buffer is also the value
  a model trains with; here that value, with its gradient to the gate
  weight and the tokens, is ``aux``, set by every forward: to train with
  the term, return ``layer.aux`` from the model and add ``weight * aux``
  in the loss (a loss that reads it from the layer instead counts it
  once per batch rank under ``ShardedTrainStep``).

**The dispatch is by index**, not by the JAX layer's one-hot einsums
(O(N E C D)): each kept choice's slot ``e * C + position`` is computed
from integer counts, the tokens are scatter-added into ``[E * C, D]``
(each slot receives at most one token, so the sum is the token itself)
and the outputs are gathered back. A dropped choice points at a spare row
that no expert reads and whose output has weight 0. The results equal the
dense einsums' up to the order of fp32 sums over a token's ``k`` terms.

**Expert parallelism** (``parallel.ShardedTrainStep`` with
``moe_param_rule("ep")`` sets ``_pt_ep``): a rank holds and multiplies
only its ``E / ep`` experts; the tokens are replicated over ``ep``.

- The gate runs on every ``ep`` rank alike. Each rank dispatches its
  tokens' choices of its own experts, and its combine sums those
  choices only; an all-reduce over ``ep`` after the combine forms every
  token's whole output (Megatron's ``g``).
- Backward, each rank's cotangents of the dispatched tokens and of the
  gate probabilities the combine reads cover its own experts' choices:
  both pass through Megatron's ``f`` (identity forward, all-reduce over
  ``ep`` backward), so the gate weight's gradient is summed over ``ep``
  exactly once. ``aux`` reads the probabilities before ``f``: every
  ``ep`` rank computes it whole, like the rest of the replicated model,
  which sees the same inputs and cotangents on every ``ep`` rank.
- The JAX step sees the GLOBAL batch. When the rows are split over a
  batch group (``nn.norm.global_batch``, as BatchNorm gets it), the
  per-(choice, expert) counts and the gate probabilities' sums are
  all-gathered over it (one ``[k E + E]`` fp32 vector a layer): the
  capacity counts the global ``N``, a token's slot counts the choices of
  every earlier token on every rank (the earlier choices' totals, then
  this choice's counts on the ranks before this one), and ``aux``
  averages over the global batch. The gather's backward reduce-scatters
  the cotangents, so each rank's probabilities take every rank's share
  of ``aux``'s gradient (the step keeps 1 / ranks of a returned scalar's
  cotangent on each).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.place import resolve_device
from ..ops import activation as _A
from ..ops.search import topk
from . import initializer as I
from . import norm as _norm
from .layer import Layer

__all__ = ["MoELayer", "moe_param_rule"]


class Routing(NamedTuple):
    """The gate's choices (``MoELayer.route``): per token and choice the
    gate probability ``prob`` (fp32, differentiable), the ``expert``, the
    ``position`` in its queue and whether it is kept (``keep``); the
    ``capacity`` and ``aux``, the load-balance term (differentiable)."""
    prob: torch.Tensor
    expert: torch.Tensor
    position: torch.Tensor
    keep: torch.Tensor
    capacity: int
    aux: torch.Tensor


class MoELayer(Layer):
    """Top-k gated MoE FFN: ``x [B, T, D]`` -> ``[B, T, D]``; each expert
    is a 2-layer FFN with stacked weights ``w_in [E, D, H]`` and ``w_out
    [E, H, D]`` (see the module note)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.capacity_factor = capacity_factor
        init = I.XavierUniform()
        kw = dict(device=device, generator=generator)
        self.gate_weight = I.make_param(None, init, (d_model, num_experts),
                                        **kw)
        self.w_in = I.make_param(None, init,
                                 (num_experts, d_model, d_hidden), **kw)
        self.b_in = I.make_param(None, I.Constant(0.0),
                                 (num_experts, d_hidden), **kw)
        self.w_out = I.make_param(None, init,
                                  (num_experts, d_hidden, d_model), **kw)
        self.b_out = I.make_param(None, I.Constant(0.0),
                                  (num_experts, d_model), **kw)
        self.register_buffer("aux_loss", torch.zeros((), dtype=torch.float32,
                                                     device=device))
        self._act = getattr(_A, activation)
        # (process group, this rank's index, ranks) of the expert axis,
        # set by ShardedTrainStep's expert-parallel placement
        self._pt_ep: Optional[Tuple[object, int, int]] = None
        self.aux: Optional[torch.Tensor] = None  # the last forward's term

    def capacity(self, n_tokens: int) -> int:
        return max(1, math.ceil(self.capacity_factor * n_tokens
                                * self.top_k / self.num_experts))

    def route(self, tokens: torch.Tensor, ep_group=None) -> Routing:
        """The gate's choices for ``tokens [N, D]`` over the global batch
        (see the module note): each choice's expert, probability and
        slot, whether it is kept, the capacity, and ``aux``. With
        ``ep_group`` the probabilities the choices read pass through
        Megatron's ``f`` over it; ``aux`` reads them before."""
        n, e, k = tokens.shape[0], self.num_experts, self.top_k
        probs = torch.softmax((tokens @ self.gate_weight).float(), dim=-1)
        prob_sum = probs.sum(0)  # [E]
        if ep_group is not None:
            from ..parallel.spmd import _CopyToMP
            probs = _CopyToMP.apply(probs, ep_group)
        top_p, top_e = topk(probs, k)  # [N, k], ties to the lower index
        choice = torch.nn.functional.one_hot(top_e, e)  # [N, k, E] int64
        counts = choice.sum(0)  # [k, E]: this rank's choices per expert

        # the global batch: counts (and probability sums) of every rank
        group = _norm.global_batch_group()
        if group is None:
            total, before, n_all, prob_all = counts, 0, n, prob_sum
        else:
            from ..parallel import collective as _c
            vec = torch.cat([counts.reshape(-1).to(torch.float32),
                             prob_sum])[None]
            _c._account("all_gather", vec)
            rows = _c._AllGather.apply(vec, 0, group)  # [R, k E + E]
            ranks = rows.shape[0]
            every = rows.detach()[:, :k * e].round().to(torch.int64)
            every = every.reshape(ranks, k, e)
            total = every.sum(0)
            before = every[:dist.get_rank(group)].sum(0)
            n_all = n * ranks
            prob_all = rows[:, k * e:].sum(0)
        cap = self.capacity(n_all)

        # slot order k-major: the earlier choices' totals, this choice's
        # counts on the ranks before this one, then the local prior count
        offset = torch.cumsum(total, 0) - total + before  # [k, E]
        ck = choice.transpose(0, 1)  # [k, N, E]
        prior = torch.cumsum(ck, 1) - ck
        position = ((prior + offset[:, None, :]) * ck).sum(-1).t()  # [N, k]
        frac = total[0].to(torch.float32) / n_all  # top-1 fraction
        aux = e * torch.sum(frac * (prob_all / n_all))
        return Routing(top_p, top_e, position, position < cap, cap, aux)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        n, k = b * t, self.top_k
        tokens = x.reshape(n, d)
        ep = self._pt_ep
        group = None if ep is None else ep[0]
        r = self.route(tokens, group)
        self.aux = r.aux
        with torch.no_grad():
            self.aux_loss.copy_(r.aux)
        if group is not None:
            # Megatron's f over the expert axis (its g after the combine)
            from ..parallel.spmd import _CopyToMP
            tokens = _CopyToMP.apply(tokens, group)

        # this rank's experts (all of them without expert parallelism)
        local, cap = self.w_in.shape[0], r.capacity
        first = 0 if ep is None else ep[1] * local
        le = r.expert - first
        mine = r.keep & (le >= 0) & (le < local)
        spare = local * cap
        slot = torch.where(mine, le * cap + r.position,
                           torch.full_like(r.position, spare)).reshape(-1)
        src = tokens.float()[:, None, :].expand(n, k, d).reshape(n * k, d)
        expert_in = torch.zeros((spare + 1, d), dtype=torch.float32,
                                device=x.device).index_add(0, slot, src)
        expert_in = expert_in[:spare].reshape(local, cap, d).to(x.dtype)
        h = self._act(torch.bmm(expert_in, self.w_in) + self.b_in[:, None])
        out = torch.bmm(h, self.w_out) + self.b_out[:, None]  # [E, C, D]

        gates = r.prob * mine  # fp32 [N, k]
        out = torch.cat([out.float().reshape(spare, d),
                         out.new_zeros((1, d), dtype=torch.float32)])
        y = (out.index_select(0, slot).reshape(n, k, d)
             * gates[..., None]).sum(1)
        if group is not None:
            from ..parallel.spmd import _ReduceFromMP
            y = _ReduceFromMP.apply(y, group)
        return y.to(x.dtype).reshape(b, t, d)


def moe_param_rule(ep_axis: str = "ep"):
    """``param_rule`` for ``ShardedTrainStep``: the stacked expert
    dimension of ``w_in``/``w_out``/``b_in``/``b_out`` split over the
    ``ep`` mesh axis, everything else replicated."""
    from ..parallel.mesh import PartitionSpec as P

    def rule(name: str, v) -> P:
        shape = getattr(v, "shape", ())
        leaf = name.split(".")[-1]
        if leaf in ("w_in", "w_out", "b_in", "b_out") and len(shape) >= 2:
            return P(ep_axis, *([None] * (len(shape) - 1)))
        return P()

    return rule
