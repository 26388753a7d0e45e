"""Pipeline parallelism: the GPipe fill-drain schedule over a ``pp`` axis.

Counterpart of ``paddle_tpu.parallel.pipeline`` (``stack_stage_params``,
``gpipe``, ``GPipeTrainStep``). The JAX module runs the schedule inside one
SPMD program: every device holds one stage's parameters, a loop of
``M + S - 1`` ticks feeds microbatch ``t`` to stage 0 and hops every
stage's output to the next stage with ``lax.ppermute``, the last stage
records its outputs, and a ``psum`` hands them to every device; ``jax.grad``
transposes the hops. Here each rank is one process holding one stage
(rank ``i`` of the ``pp`` axis runs stage ``i``), and the same loop runs on
every rank:

- every tick every rank runs its stage on its input (stage 0: microbatch
  ``min(t, M - 1)``; the others: what arrived from the previous stage),
  bubbles included, as the JAX program does; the outputs hop one stage
  forward through ``collective.ppermute`` over the ring;
- which input a rank takes and whether it records an output are 0/1
  masks, not branches, so every rank builds the same autograd graph and
  so issues the same collectives in the same order, forward and
  backward (a rank whose outputs are masked away still runs the hops'
  backward: the gradients flow back through the same hops under
  autograd, each the inverse permutation);
- the recorded outputs are summed over ``pp`` (only the last stage's are
  not zero) by an all-reduce whose backward is the identity, so each
  rank's cotangent reaches its own (masked) outputs once; ``x``, given
  on every rank and read by stage 0 alone, enters through ``_CopyToMP``
  over ``pp`` (identity forward, all-reduce backward), so every rank gets
  its gradient, as the JAX program's replicated input does.

The stage function must be shape-preserving (a transformer trunk).
``GPipeTrainStep`` runs the embedding and the head on every rank, outside
the pipeline, as the JAX program runs them replicated: the head sees the
same outputs on every rank and so computes the same loss and the same
head gradient; the embedding's output is the schedule's ``x``, so its
gradient is the same on every rank too.
The step is ``static.TrainStep`` over that whole (one optimizer over the
embedding's, this rank's stage's and the head's parameters, named
``embed.*``, ``stages.*`` and ``head.*``): eager under Gloo, captured as
one CUDA graph under NCCL. ``remat_stages`` recomputes a stage's
activations in the backward (``torch.utils.checkpoint``), trading one
stage forward for the stored intermediates, as ``jax.checkpoint`` does.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import random as _random
from ..optimizer import Optimizer
from ..static import TrainStep
from . import collective as _c
from . import env as _env
from .mesh import Mesh
from .spmd import _CopyToMP, _ReduceFromMP

__all__ = ["stack_stage_params", "gpipe", "GPipeTrainStep"]


def stack_stage_params(stage_layers: Sequence[nn.Module]
                       ) -> Dict[str, torch.Tensor]:
    """Every stage's parameters stacked on a new leading stage axis (the
    stages must share one structure)."""
    dicts = [dict(layer.named_parameters()) for layer in stage_layers]
    return {n: torch.stack([d[n].detach() for d in dicts])
            for n in dicts[0]}


def _stage_index(mesh: Mesh, axis: str) -> int:
    return mesh.axis_index(axis) if mesh.coordinate is not None else 0


def _schedule(stage: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor, num_microbatches: int, mesh: Mesh,
              axis: str) -> torch.Tensor:
    """The fill-drain schedule (see the module note) of ``stage``, this
    rank's stage, over ``x`` [B, ...] given on every rank; returns the
    composition of all stages, on every rank."""
    n = mesh.shape[axis]
    m = int(num_microbatches)
    if x.shape[0] % m:
        raise ValueError(f"gpipe: batch {x.shape[0]} does not split into "
                         f"{m} microbatches")
    me = _stage_index(mesh, axis)
    pg = mesh.group(axis)
    if pg is not None:
        # only stage 0 reads x: every rank's x gets that gradient
        x = _CopyToMP.apply(x, pg)
    micro = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
    # filled on the device (a captured step copies nothing from the host)
    first = torch.full((), float(me == 0), dtype=x.dtype, device=x.device)
    last = torch.full((), float(me == n - 1), dtype=x.dtype,
                      device=x.device)
    ring = [(i, (i + 1) % n) for i in range(n)]
    recv = torch.zeros_like(micro[0])
    outputs = [None] * m
    for t in range(m + n - 1):
        inp = first * micro[min(t, m - 1)] + (1 - first) * recv
        out = stage(inp)
        if t >= n - 1:
            outputs[t - (n - 1)] = out * last
        if t < m + n - 2:
            recv = _c.ppermute(out, ring, group=pg) if pg is not None \
                else out
    y = torch.stack(outputs)
    if pg is not None:
        y = _ReduceFromMP.apply(y, pg)
    return y.reshape(tuple(x.shape[:1]) + tuple(y.shape[2:]))


def gpipe(stage_fn: Callable, stacked_params: Dict[str, torch.Tensor],
          x: torch.Tensor, num_microbatches: int, mesh: Mesh,
          axis: str = "pp") -> torch.Tensor:
    """Runs the GPipe schedule over the ``axis`` ranks:
    ``stage_fn(params_slice, x_mb) -> y_mb`` (shape-preserving), with
    ``stacked_params`` a dict of tensors whose leading dim is the stage
    count (this rank reads its own slice); ``x`` [B, ...] on every rank,
    B divisible by ``num_microbatches``. Returns the composition of all
    stages, on every rank."""
    me = _stage_index(mesh, axis)
    local = {k: v[me] for k, v in stacked_params.items()}
    return _schedule(lambda xb: stage_fn(local, xb), x, num_microbatches,
                     mesh, axis)


class _Pipeline(nn.Module):
    """embed -> the pipelined trunk (this rank's stage) -> head."""

    def __init__(self, embed: nn.Module, stage: nn.Module, head: nn.Module,
                 mesh: Mesh, num_microbatches: int, axis: str,
                 remat: bool) -> None:
        super().__init__()
        self.embed, self.stages, self.head = embed, stage, head
        self.mesh, self.m, self.axis, self.remat = (mesh, num_microbatches,
                                                    axis, remat)

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return self.stages(x)
        tape = _random.DrawTape()

        def run(a):
            with _random.replay_draws(tape):
                return self.stages(a)

        return checkpoint(run, x, use_reentrant=False,
                          preserve_rng_state=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _schedule(self._stage, self.embed(x), self.m, self.mesh,
                      self.axis)
        return self.head(h)


class GPipeTrainStep(TrainStep):
    """``GPipeTrainStep(embed, stage_layers, head, optimizer, loss_fn,
    mesh, num_microbatches)``; ``step(x, labels=(...))`` runs one step of
    embed -> GPipe over the ``axis`` ranks -> head -> loss -> update and
    returns ``{"loss": ...}`` (the same on every rank). Rank ``i`` of the
    axis trains ``stage_layers[i]``; the others' are not touched there.
    ``optimizer_fused_state`` is refused, as in the JAX package."""

    def __init__(self, embed: nn.Module, stage_layers: Sequence[nn.Module],
                 head: nn.Module, optimizer: Optimizer, loss_fn: Callable,
                 mesh: Mesh, num_microbatches: int, axis: str = "pp",
                 remat_stages: bool = False, seed: int = 0) -> None:
        n = mesh.shape[axis]
        if len(stage_layers) != n:
            raise ValueError(f"need {n} stages, got {len(stage_layers)}")
        if optimizer._use_fused():
            raise ValueError(
                "optimizer_fused_state is incompatible with pipeline "
                "stage-stacked optimizer state; construct the optimizer "
                "with fused_state=False")
        self.mesh, self.axis, self.m = mesh, axis, int(num_microbatches)
        self.stage_layers = list(stage_layers)
        self.stage_id = _stage_index(mesh, axis)
        self.embed, self.head = embed, head
        pipe = _Pipeline(embed, self.stage_layers[self.stage_id], head, mesh,
                         self.m, axis, remat_stages)
        gloo = _env.is_initialized() and _env.backend() == "gloo"
        super().__init__(pipe, optimizer, loss_fn, seed=seed,
                         compiled=False if gloo else None)
        self._span_name = f"GPipeTrainStep({type(embed).__name__})"

    def __call__(self, x, labels=()):
        with self.mesh:
            return super().__call__(x, labels=labels)
