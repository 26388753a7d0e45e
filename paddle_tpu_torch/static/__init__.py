"""TrainStep and EvalStep: one optimizer step, and one evaluation, of a
model.

Counterpart of ``paddle_tpu.static.TrainStep`` and ``EvalStep``. The JAX
class compiles forward, backward and the update into one donated-state
XLA program. Here the step is the model's forward and the loss under the
step's dropout stream (one generator per ``TrainStep``, seeded from
``seed`` and advanced by every step, as the JAX step splits its ``rng``
key), ``torch.autograd.grad`` over the trainable parameters (a parameter
the loss does not reach gets a zero gradient, as JAX gives it), and the
optimizer's in-place update of the model's own parameters. On the card
that step is captured as one CUDA graph per input signature and
replayed, the counterpart of the jitted step (below); on the CPU it runs
eagerly.

- The skip-step guard (``skip_nonfinite_steps``, read at construction):
  when any gradient is NaN/Inf the whole update is discarded,
  parameters, fp32 masters, optimizer moments and the step counter
  alike, selected on the device (no host sync); ``nonfinite_steps``
  counts such steps on the device.
- ``amp_dtype`` runs the forward under ``amp.auto_cast`` (thread-local
  state only, as in the JAX package; the model's dtypes are its own:
  cast it with ``amp.cast_model_to_low_precision``). A ``GradScaler``
  scales the loss, unscales the gradients in their dtype and checks
  them, discards a non-finite step whatever the flag, and updates its
  state in place, all on the device (``scaler_state``).
- A host-driven scheduler (``ReduceOnPlateau``) reaches the optimizer as
  ``lr_override``: its live host value is written into ``host_lr``, a
  persistent fp32 device tensor, before each step (the JAX step takes it
  as an fp32 argument).
- ``extra_metrics`` ``{name: fn(outputs, *labels)}`` are computed on the
  step's own forward outputs, before the update.
- ``run_steps`` runs K stacked batches as K steps (see there).

**The captured step** (``compiled``; by default on for a model on the
card, off on the CPU; ``compiled=True`` with CPU parameters raises). A
step's signature is the shapes, dtypes and devices of its tensor
inputs, the values of its other inputs, every flag's value (the flags
choose the kernels' routes inside the step), the model's training mode,
whether a host-driven rate is given, and a float learning rate. The
first step of a new signature runs eagerly on a side stream (the
warm-up, a real step); then the step is captured into a CUDA graph over
static input buffers, which records its kernels and runs nothing, so
parameters, state, the generator and the launch counters are as they
were; each later step of that signature copies its inputs into the
buffers and replays the graph, one host launch. Everything the step
reads or writes stays at its address: the optimizer and the scaler
update their state in place, the host rate is ``host_lr``, the
generator is registered with the graph (each replay advances it as an
eager step would, so captured and eager steps draw the same bits), and
the fused Adam kernel's leaf table is made with the graph
(``kernels.fused_adam.captured_tables``). A replay adds to the kernels'
launch counters what its capture recorded. The metrics come back as
clones of the graph's outputs. ``captures`` counts the captures (the
JAX tracker's ``jit_traces_total``) and ``capture_ms`` their host time.
A failed capture or replay raises; nothing falls back to the eager
step. Python values read during the capture (the optimizer's and the
scaler's hyperparameters, a scheduler's constants) are baked into the
graph. Assigning ``state``, ``scaler_state`` or calling
``reset_from_model`` drops the graphs, and so does dropping the step.

Not ported: the observability probes, fault multipliers and the
divergence-rollback LR scale; buffers the forward updates are not
guarded (the ported models have none).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from .. import amp as _amp
from .. import kernels
from ..core import random as _random
from ..flags import GLOBAL_FLAGS
from ..kernels import fused_adam as _adam
from ..optimizer import Optimizer

__all__ = ["TrainStep", "EvalStep"]


def _labels(labels) -> tuple:
    return tuple(labels) if isinstance(labels, (tuple, list)) \
        else (labels,)


def _host_lr(optimizer) -> Optional[float]:
    """The live value of a host-driven scheduler (a host float, no
    device read), else None."""
    sched = getattr(optimizer, "learning_rate", None)
    if getattr(sched, "host_driven", False):
        return float(sched.get_lr())
    return None


def _wire_param_meta(model: nn.Module, optimizer: Optimizer) -> None:
    """Hand each parameter's ``need_clip`` / ``regularizer`` attributes
    (where set) to the optimizer, keyed by parameter name."""
    meta = {}
    for n, p in model.named_parameters():
        need_clip = getattr(p, "need_clip", True)
        reg = getattr(p, "regularizer", None)
        if not need_clip or reg is not None:
            meta[n] = (need_clip, reg)
    if meta:
        optimizer.set_param_meta(meta)


def _index(tree, i: int):
    """Entry ``i`` of the leading axis of every tensor in ``tree``."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, i) for v in tree)
    return tree


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _signature(tree) -> tuple:
    """The hashable signature of an input tree: each tensor's shape,
    dtype and device, every other leaf's value."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _signature(v))
                                 for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    return ("value", tree)


def _clone_tree(tree):
    """The tree with every tensor replaced by a copy of it."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree


def _copy_tree(dst, src) -> None:
    """Copies every tensor of ``src`` into its place in ``dst`` (two
    trees of one signature)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _copy_tree(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_tree(d, s)


class _Graph:
    """One signature's captured step: the static input buffers the graph
    reads (``inputs``: args, labels, kwargs), the graph, its outputs, the
    kernel launches one replay makes (name -> count) and the device
    tensors the graph reads that nothing else holds (``keep``)."""

    def __init__(self, inputs) -> None:
        self.inputs = _clone_tree(inputs)
        self.graph: Any = None
        self.outputs: Dict[str, Any] = {}
        self.launches: Dict[str, int] = {}
        self.keep: list = []

    def replay(self, inputs) -> Dict[str, Any]:
        """Copies ``inputs`` into the buffers, replays the graph, adds its
        launches to the counters and returns clones of its outputs (the
        next replay overwrites them)."""
        _copy_tree(self.inputs, inputs)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        return {k: v.clone() if isinstance(v, torch.Tensor) else v
                for k, v in self.outputs.items()}


# the side stream of every step's warm-up and capture, by device: one
# per device, as cuBLAS keeps a workspace for each stream it meets
_side_streams: Dict[torch.device, Any] = {}


class _CudaGraphs:
    """Warm-up and capture on the card: one side stream for both (the
    warm-up makes what the capture then finds, such as cuBLAS's workspace
    for that stream), a private memory pool per graph, and the step's
    generator registered with each graph."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        if device not in _side_streams:
            _side_streams[device] = torch.cuda.Stream(device)
        self.stream = _side_streams[device]

    def warm_up(self, fn: Callable[[], Any]) -> Any:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable[[], Any], generator: torch.Generator,
                table_rows: int) -> tuple:
        """``(graph, tensors to keep with it)``; ``table_rows`` bounds the
        rows of the fused Adam kernel's leaf tables in the step."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        with _adam.captured_tables(table_rows, self.device) as tables:
            with torch.cuda.graph(graph, stream=self.stream):
                fn()
        return graph, tables


class TrainStep:
    """``step = TrainStep(model, opt, loss_fn)``; ``step(*args,
    labels=(...), **kwargs)`` runs ``loss_fn(model(*args, **kwargs),
    *labels)``, updates the model in place and returns ``{"loss": loss,
    <extra metrics>}`` (0-d device tensors, not synchronised).
    ``compiled`` (None: the card captures, the CPU runs eagerly) is the
    captured step of the module note."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 loss_fn: Callable,
                 extra_metrics: Optional[Dict[str, Callable]] = None,
                 seed: int = 0, amp_dtype=None, scaler=None,
                 compiled: Optional[bool] = None) -> None:
        self.model = model
        self.optimizer = optimizer
        _wire_param_meta(model, optimizer)
        self.loss_fn = loss_fn
        self.extra_metrics = dict(extra_metrics or {})
        self.seed = int(seed)
        self.amp_dtype = amp_dtype
        if scaler is not None and not scaler.enable:
            scaler = None
        self.scaler = scaler
        self.params: Dict[str, torch.Tensor] = {
            n: p for n, p in model.named_parameters() if p.requires_grad}
        if not self.params:
            raise ValueError("TrainStep: the model has no trainable "
                             "parameters")
        self.device = next(iter(self.params.values())).device
        on_card = self.device.type == "cuda"
        if compiled and not on_card:
            raise ValueError(f"TrainStep(compiled=True) captures a CUDA "
                             f"graph, but the model's parameters are on "
                             f"{self.device}")
        self.compiled = on_card if compiled is None else bool(compiled)
        self._graphs: Dict[tuple, _Graph] = {}
        self._backend = _CudaGraphs(self.device) if self.compiled else None
        self.captures = 0
        self.capture_ms = 0.0
        self.state = optimizer.init(self.params)
        self.scaler_state = None if scaler is None \
            else scaler.init(self.device)
        self._skip_guard = bool(GLOBAL_FLAGS.get("skip_nonfinite_steps"))
        self.calls = 0
        self.nonfinite_steps = torch.zeros((), dtype=torch.int64,
                                           device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.host_lr = torch.zeros((), dtype=torch.float32,
                                   device=self.device)

    # assigning the optimizer or scaler state drops the graphs, which read
    # the old tensors
    @property
    def state(self) -> dict:
        return self._state

    @state.setter
    def state(self, value: dict) -> None:
        self._state = value
        self._graphs.clear()

    @property
    def scaler_state(self) -> Optional[Dict[str, torch.Tensor]]:
        return self._scaler_state

    @scaler_state.setter
    def scaler_state(self, value) -> None:
        self._scaler_state = value
        self._graphs.clear()

    def _step(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        """The step itself: what the eager step runs and the graph
        records."""
        gen = self.generator
        amp = _amp.auto_cast(enable=True, dtype=self.amp_dtype) \
            if self.amp_dtype is not None else contextlib.nullcontext()
        with amp, _random.rng_scope(default=gen, dropout=gen):
            out = self.model(*args, **kwargs)
            loss = self.loss_fn(out, *labels)
        scaler = self.scaler
        if scaler is not None:
            loss = scaler.scale(loss, self.scaler_state)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as JAX
        # differentiates every parameter: AdamW still decays it and its
        # moments, and the skip guard and the fused routes cover it
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        loss = loss.detach()
        found_inf = None
        if scaler is not None:
            grads, found_inf = scaler.unscale(grads, self.scaler_state)
            loss = loss / self.scaler_state["scale"].to(loss.dtype)
        elif self._skip_guard:
            found_inf = ~_amp.all_finite(grads)
        metrics = {"loss": loss}
        if self.extra_metrics:
            # on this step's outputs, before the update rewrites the
            # parameters they may hold (MLMHeadOutput's tied weight)
            with torch.no_grad():
                for name, fn in self.extra_metrics.items():
                    metrics[name] = fn(out, *labels)
        ok = None
        if found_inf is not None:
            ok = ~found_inf
            self.nonfinite_steps += found_inf.to(torch.int64)
        self.optimizer.apply_gradients(self.params, grads, self.state, ok,
                                       lr_override=lr)
        if scaler is not None:
            scaler.update(self.scaler_state, found_inf)
        return metrics

    def _lr(self) -> Optional[torch.Tensor]:
        """``host_lr`` holding the host-driven scheduler's live value
        (written outside any graph), else None."""
        lr = _host_lr(self.optimizer)
        if lr is None:
            return None
        self.host_lr.fill_(lr)
        return self.host_lr

    def _run(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        """One step: eager, or the replay of its signature's graph (the
        first step of a signature runs eagerly as the warm-up, and the
        graph is captured after it)."""
        self.calls += 1
        if not self.compiled:
            return self._step(args, labels, kwargs, lr)
        inputs = (args, labels, kwargs)
        rate = self.optimizer.learning_rate
        key = (_signature(inputs), GLOBAL_FLAGS.snapshot(),
               self.model.training, lr is None,
               rate if isinstance(rate, (int, float)) else None)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.replay(inputs)
        metrics = self._backend.warm_up(
            lambda: self._step(args, labels, kwargs, lr))
        graph = _Graph(inputs)
        self._capture(graph, lr)
        self._graphs[key] = graph
        return metrics

    def _capture(self, graph: _Graph, lr) -> None:
        """Records the step over ``graph``'s buffers. The capture runs
        nothing, so what its wrappers counted is taken back off the
        counters and kept as the launches of one replay."""
        t0 = time.perf_counter()
        before = kernels.launch_counts()

        def body() -> None:
            graph.outputs = self._step(*graph.inputs, lr)

        # every leaf in at most one table (a flat fused master is one)
        graph.graph, graph.keep = self._backend.capture(
            body, self.generator, len(self.params) + 1)
        after = kernels.launch_counts()
        graph.launches = {k: n - before[k] for k, n in after.items()
                          if n != before[k]}
        kernels.add_launch_counts(graph.launches, -1)
        self.captures += 1
        self.capture_ms += (time.perf_counter() - t0) * 1e3

    def __call__(self, *args, labels=(), **kwargs) -> Dict[str,
                                                           torch.Tensor]:
        return self._run(args, _labels(labels), kwargs, self._lr())

    def run_steps(self, *args, labels=(), **kwargs) -> Dict[str,
                                                            torch.Tensor]:
        """K steps over K stacked batches: every tensor of ``args``,
        ``labels`` and ``kwargs`` carries a leading axis K. The steps draw
        the same dropout streams as K calls, a host-driven scheduler's
        live value is read once and held for the K steps, and the
        metrics come back stacked on a leading K axis
        (``metrics["loss"][-1]`` is the latest). Runs the K steps one by
        one, each as a call would (a replay when captured); the JAX
        package's one compiled scan is its speed, not its function."""
        labels = _labels(labels)
        first = _first_tensor((args, labels, kwargs))
        if first is None or first.ndim == 0:
            raise ValueError("run_steps needs batches stacked on a "
                             "leading steps axis")
        lr = self._lr()
        per = [self._run(_index(args, i), _index(labels, i),
                         _index(kwargs, i), lr)
               for i in range(first.shape[0])]
        return {k: torch.stack([m[k] for m in per]) for k in per[0]}

    def reset_from_model(self) -> None:
        """Re-read the model's trainable parameters (after parameters
        were replaced on the model) and drop the graphs (they read the
        old ones). The optimizer state carries over, as in the JAX
        package, fp32 masters included: a bf16 parameter's next update
        starts from its master, so re-``init`` the state (``step.state =
        step.optimizer.init(step.params)``) to train on from weights
        loaded into a low-precision model."""
        self.params = {n: p for n, p in self.model.named_parameters()
                       if p.requires_grad}
        self._graphs.clear()


class EvalStep:
    """Inference step: ``EvalStep(model, metric_fns)(params, buffers,
    *args, labels=())`` runs the model in eval mode without autograd and
    returns ``(outputs, {name: fn(outputs, *labels)})``. ``params`` /
    ``buffers`` (name -> tensor) replace the model's own for the call
    (``torch.func.functional_call``); None uses the model's. The model's
    training mode is restored after."""

    def __init__(self, model: nn.Module,
                 metric_fns: Optional[Dict[str, Callable]] = None) -> None:
        self.model = model
        self.metric_fns = dict(metric_fns or {})

    @torch.no_grad()
    def __call__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 buffers: Optional[Dict[str, torch.Tensor]] = None,
                 *args: Any, labels=()):
        labels = _labels(labels)
        was_training = self.model.training
        self.model.eval()
        try:
            if params is None and buffers is None:
                out = self.model(*args)
            else:
                out = torch.func.functional_call(
                    self.model, {**(params or {}), **(buffers or {})}, args)
        finally:
            if was_training:
                self.model.train()
        metrics = {name: fn(out, *labels)
                   for name, fn in self.metric_fns.items()}
        return out, metrics
