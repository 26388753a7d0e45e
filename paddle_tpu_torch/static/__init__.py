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
- A float rate and a host-driven scheduler (``ReduceOnPlateau``) reach
  the optimizer as ``lr_override``: the live host value (the float as
  ``optimizer.set_lr`` last left it, or the scheduler's ``get_lr()``) is
  written into ``host_lr``, a persistent fp32 device tensor, before each
  step (the JAX step takes a scheduler's as an fp32 argument, and
  rounds a float to fp32 as ``jnp.asarray(lr, float32)``). A scheduler
  that computes its rate on the device from the step counter reads
  nothing from the host.
- ``extra_metrics`` ``{name: fn(outputs, *labels)}`` are computed on the
  step's own forward outputs, before the update.
- ``run_steps`` runs K stacked batches as K steps (see there).

**The captured step** (``compiled``; by default on for a model on the
card, off on the CPU; ``compiled=True`` with CPU parameters raises). A
step's signature is the shapes, dtypes and devices of its tensor
inputs, the values of its other inputs, every flag's value (the flags
choose the kernels' routes inside the step), the model's training mode
and whether a host rate is given. The
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
graph; the rate is not, as it is read from ``host_lr``, so a new rate
(``optimizer.set_lr``) between two replays takes effect at the next one
with the same graph. Assigning ``state``, ``scaler_state`` or calling
``reset_from_model`` drops the graphs, and so does dropping the step.

**The checkpointable state** (``state_dict()`` / ``set_state_dict()``):
the whole training state as one tree with the JAX ``TrainStep.state``'s
leaf paths, ``params/<name>``, ``buffers/<name>``, ``opt/step``,
``opt/slots/<name>/{m,v[,master]}``, ``opt/fused/{m,v,master}`` and
``scaler/...``, plus ``generator``, the step generator's state as uint8
(a key the JAX state lacks, so the JAX package's ``io.load(path,
target=step.state)`` passes it by and keeps its own ``rng``). Saved with
``io.save``/``io.AsyncCheckpointer``, a port manifest lists the JAX
one's leaves, shapes and dtypes, but for the generator leaf in place of
``rng``. ``set_state_dict`` writes IN PLACE (``copy_`` into every
parameter, master, moment, step counter and scaler tensor, and the
generator's seed and offset set), so the captured graphs stay valid:
they read fixed addresses. A JAX checkpoint's ``rng`` key seeds the
generator by one rule (:func:`seed_from_key_bits`); it cannot be
continued, as Philox is not threefry.

``EvalStep`` is captured too (one CUDA graph per signature of its inputs,
its parameter source and the flags), its metric functions inside the
graph, as they run inside the JAX package's jit.

**Observability and value faults**, as the JAX step's (with
FLAGS_enable_metrics on): a span ``TrainStep(<model>)`` around each step
(around the replay on the card; ``EvalStep(<model>)`` likewise),
``optimizer_steps_total``, and each capture and replay in the capture
tracker's ``jit_*`` series (``observability.recompile``). Nothing on the
host runs inside a graph at replay, so the probes take the JAX step's
callback-free route: the skip verdict and the gradient global norm are
step outputs (the ``_pt_nonfinite``/``_pt_gnorm`` leaves of the JAX step
under a compile cache), copied with the loss to pinned host memory
behind a CUDA event, and ``flush_signals`` hands them to the anomaly
sentinel and to ``nonfinite_steps_total`` once the event has completed
(``block=False``, called after every step: no sync) or at once
(``sync_to_model``, a blocking flush). The eager step takes the same
route, so captured and eager steps count alike. Value faults
(``testing.faults``' ``nonfinite_grad`` and ``loss_spike``) are two fp32
device scalars, written in place before each step while such a point is
armed (1.0 when not firing): arming or disarming changes the signature
once, a fault firing at ``step=N`` does not (its trigger reads the host
step count of ``faults.set_step_context``). ``lr_scale`` (the
divergence-rollback rescale) multiplies the rate on the host and reaches
the step through ``host_lr``, so a rescale reuses the graph (a rate the
step computes on the device from its counter is multiplied there by the
scale, which ``host_lr`` then holds).

Not ported: buffers the forward updates are not guarded (the ported
models have none).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import amp as _amp
from .. import io as _io
from .. import kernels
from .. import observability as _obs
from ..convert import tensor_from_numpy
from ..core import random as _random
from ..flags import GLOBAL_FLAGS
from ..kernels import fused_adam as _adam
from ..observability import flight as _flight
from ..observability import xprof as _xprof
from ..observability.recompile import signature_text
from ..optimizer import LRScheduler, Optimizer
from ..optimizer.lr import resolve_lr
from ..testing import faults as _faults

__all__ = ["TrainStep", "EvalStep", "seed_from_key_bits"]


def _labels(labels) -> tuple:
    return tuple(labels) if isinstance(labels, (tuple, list)) \
        else (labels,)


def _host_lr(optimizer) -> Optional[float]:
    """The live host value of the rate: a float rate, or a host-driven
    scheduler's (no device read); None for a scheduler computed on the
    device."""
    rate = optimizer.learning_rate
    if not isinstance(rate, LRScheduler):
        return float(rate)
    if rate.host_driven:
        return float(rate.get_lr())
    return None


_NONFINITE_HELP = ("train steps whose gradients contained NaN/Inf — the "
                   "optimizer/scaler/buffer update was skipped in-graph "
                   "(skip-step guard, FLAGS_skip_nonfinite_steps)")


def _note_nonfinite_host(fired: bool) -> None:
    if not fired:
        return
    _obs.counter("nonfinite_steps_total", _NONFINITE_HELP).inc()
    _flight.record("nonfinite_step", force=True)


def _register_probe_series() -> None:
    """Registers the probes' counters, so their TYPE lines show before
    the first incident (the JAX step registers them at trace time)."""
    _obs.counter("nonfinite_steps_total", _NONFINITE_HELP)
    _obs.counter("anomalies_total",
                 "NaN/Inf and spike events seen by the anomaly sentinel")


def apply_fault_mults(loss, grads, grad_mult, loss_mult):
    """The step's half of the value-fault injection: the loss and every
    floating gradient times the armed multipliers (device scalars; 1.0 is
    inert)."""
    loss = loss * loss_mult.to(loss.dtype)
    grads = {n: g * grad_mult.to(g.dtype) if g.is_floating_point() else g
             for n, g in grads.items()}
    return loss, grads


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
        vals = [_clone_tree(v) for v in tree]
        if hasattr(tree, "_fields"):  # a namedtuple (MLMHeadOutput)
            return type(tree)(*vals)
        return type(tree)(vals)
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

    def replay(self, inputs):
        """Copies ``inputs`` into the buffers, replays the graph, adds its
        launches to the counters and returns clones of its outputs (the
        next replay overwrites them)."""
        _copy_tree(self.inputs, inputs)
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        return _clone_tree(self.outputs)


# the side stream of every step's warm-up and capture, by device: one
# per device, as cuBLAS keeps a workspace for each stream it meets. It is
# taken from PyTorch's pool of high-priority streams, which nothing else
# in the package draws from: the default-priority pool hands its 32
# streams out in turn, so a later ``torch.cuda.Stream()`` (a
# DeviceLoader's) would come back as this one, and a pinned host block
# copied on it and freed during a capture makes every later pinned
# allocation of the process fail
_side_streams: Dict[torch.device, Any] = {}


class _CudaGraphs:
    """Warm-up and capture on the card: one side stream for both (the
    warm-up makes what the capture then finds, such as cuBLAS's workspace
    for that stream), a private memory pool per graph, and the step's
    generator registered with each graph."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        if device not in _side_streams:
            _side_streams[device] = torch.cuda.Stream(device, priority=-1)
        self.stream = _side_streams[device]

    def warm_up(self, fn: Callable[[], Any]) -> Any:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def capture(self, fn: Callable[[], Any],
                generator: Optional[torch.Generator] = None,
                table_rows: int = 0) -> tuple:
        """``(graph, tensors to keep with it)``; ``generator`` (if any) is
        registered with the graph, and ``table_rows`` bounds the rows of
        the fused Adam kernel's leaf tables in the step."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        tables = _adam.captured_tables(table_rows, self.device) \
            if table_rows else contextlib.nullcontext([])
        # thread_local: only this thread's unsafe CUDA calls invalidate
        # the capture, so another thread (the exporter answering a
        # scrape, a serving engine) may keep using the card meanwhile
        with tables as keep:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                fn()
        return graph, keep

    @contextlib.contextmanager
    def host_sync_check(self, what: str):
        """Raises, naming ``what``, if the code inside synchronises with
        the host (which a capture cannot record): CUDA's sync debug mode
        "error" for its duration."""
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            raise RuntimeError(
                f"{what} synchronises with the host, which a captured step "
                f"cannot record: return a device tensor instead of a host "
                f"value, or pass compiled=False ({e})") from e
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def _capture(owner, graph: _Graph, body: Callable[[], None],
             generator: Optional[torch.Generator] = None,
             table_rows: int = 0) -> None:
    """Records ``body`` into ``graph`` with ``owner``'s backend. The
    capture runs nothing, so what its wrappers counted is taken back off
    the counters and kept as the launches of one replay; ``owner``'s
    ``captures`` and ``capture_ms`` grow."""
    t0 = time.perf_counter()
    before = kernels.launch_counts()
    graph.graph, graph.keep = owner._backend.capture(body, generator,
                                                     table_rows)
    after = kernels.launch_counts()
    graph.launches = {k: n - before[k] for k, n in after.items()
                      if n != before[k]}
    kernels.add_launch_counts(graph.launches, -1)
    owner.captures += 1
    owner.capture_ms += (time.perf_counter() - t0) * 1e3


def _tracked(owner, key, inputs, first_call: Callable[[Callable], Any]):
    """``owner``'s call of ``inputs`` under the capture tracker: a replay
    of the graph of ``key`` (a hit), else ``first_call(count)`` (the
    warm-up and the capture: a trace, with its signature), which runs
    the warm-up inside ``count()``: the program card's FLOP counter when
    program analytics are on (``observability.xprof``), the card's
    memory window spanning the warm-up and the capture."""
    rec = _obs.recompile_tracker().function(owner._span_name)
    graph = owner._graphs.get(key)
    if graph is not None:
        out = graph.replay(inputs)
        if _obs.enabled():
            rec.on_call(0.0, traced=False)
        return out
    t0 = time.perf_counter()
    sig = signature_text(inputs)
    card = _xprof.Harvest(owner._span_name, sig, owner.device) \
        if _xprof.enabled() else None
    out = first_call(contextlib.nullcontext if card is None
                     else card.counting)
    if card is not None:
        card.finish()
    rec.note_trace(sig)
    if _obs.enabled():
        rec.on_call(time.perf_counter() - t0, traced=True)
    return out


def _eager_carded(owner, inputs, run: Callable[[], Any]):
    """An eager step's call: the first call of each signature runs under
    a program card's FLOP counter when program analytics are on (the
    eager counterpart of the card a capture takes; no extra step)."""
    if not _xprof.enabled():
        return run()
    sig = signature_text(inputs)
    if sig in owner._carded:
        return run()
    owner._carded.add(sig)
    return _xprof.harvest(owner._span_name, run, sig, owner.device)


def seed_from_key_bits(bits) -> int:
    """The seed a JAX PRNG key's raw uint32 words give the port's step
    generator: words 0 and 1 as one 64-bit integer, word 0 high (a
    missing word is 0). ``jax.random.key(n)`` for ``n < 2**32`` holds
    ``[0, n]``, so it seeds the generator with ``n``."""
    words = [int(w) & 0xFFFFFFFF
             for w in np.asarray(bits).reshape(-1)[:2].tolist()]
    words += [0] * (2 - len(words))
    return (words[0] << 32) | words[1]


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
        self._carded: set = set()  # eager signatures with a program card
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
        # host-LR rescale applied on divergence-rollback re-entry
        # (FLAGS_rollback_lr_factor), through host_lr
        self.lr_scale = 1.0
        self._lr_scaled = False  # host_lr holds the scale, not the rate
        # value-fault multipliers, written in place while a point is armed
        self._grad_mult = torch.ones((), dtype=torch.float32,
                                     device=self.device)
        self._loss_mult = torch.ones((), dtype=torch.float32,
                                     device=self.device)
        self._faults_armed = False
        # (host copy [nonfinite, grad norm, loss], its event or None,
        # whether the verdict is real) of each step not yet delivered
        self._pending_signals: list = []
        self._span_name = f"TrainStep({type(model).__name__})"

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
        if self._faults_armed:
            loss, grads = apply_fault_mults(loss, grads, self._grad_mult,
                                            self._loss_mult)
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
        if _obs.enabled():
            # the sentinel's scalars and the skip verdict ride the outputs
            # (a graph runs no host code at replay); _drain_signals takes
            # them off
            norms = torch._foreach_norm(
                [g for g in grads.values() if g.is_floating_point()], 2,
                dtype=torch.float32)
            metrics["_pt_gnorm"] = torch.linalg.vector_norm(
                torch.stack(norms))
            if found_inf is not None:
                metrics["_pt_nonfinite"] = found_inf
        ok = None
        if found_inf is not None:
            ok = ~found_inf
            self.nonfinite_steps.add_(found_inf.to(torch.int64))
        if self._lr_scaled:
            # a rate computed on the device, rescaled: host_lr holds the
            # scale (JAX: resolve_lr(rate, step + 1) * lr_scale)
            lr = resolve_lr(self.optimizer.learning_rate,
                            self.state["step"] + 1) * lr
        self.optimizer.apply_gradients(self.params, grads, self.state, ok,
                                       lr_override=lr)
        if scaler is not None:
            scaler.update(self.scaler_state, found_inf)
        return metrics

    def _lr(self, scaled: bool = True) -> Optional[torch.Tensor]:
        """``host_lr`` holding the rate's live host value times
        ``lr_scale`` (written outside any graph; the fp32 product the JAX
        step forms on the device), or, for a rate computed on the device
        with a scale other than 1, the scale; else None. ``scaled=False``
        ignores the scale (``run_steps``, as in the JAX package)."""
        lr = _host_lr(self.optimizer)
        scale = float(self.lr_scale) if scaled else 1.0
        self._lr_scaled = lr is None and scale != 1.0
        if lr is None and not self._lr_scaled:
            return None
        if self._lr_scaled:
            self.host_lr.fill_(scale)
        elif scale != 1.0:
            self.host_lr.fill_(float(np.float32(lr) * np.float32(scale)))
        else:
            self.host_lr.fill_(lr)
        return self.host_lr

    def _arm_faults(self, enable: bool = True) -> None:
        """Writes the value-fault multipliers of this step in place (a
        fill, no sync) while a value point is armed; their presence is
        part of the signature."""
        self._faults_armed = enable and _faults.active() \
            and _faults.value_points_armed()
        if self._faults_armed:
            self._grad_mult.fill_(_faults.value_mult("nonfinite_grad"))
            self._loss_mult.fill_(_faults.value_mult("loss_spike"))

    def _run(self, args, labels, kwargs, lr) -> Dict[str, torch.Tensor]:
        """One step: eager, or the replay of its signature's graph (the
        first step of a signature runs eagerly as the warm-up, and the
        graph is captured after it)."""
        self.calls += 1
        if not self.compiled:
            return _eager_carded(self, (args, labels, kwargs),
                                 lambda: self._step(args, labels, kwargs,
                                                    lr))
        inputs = (args, labels, kwargs)
        key = (_signature(inputs), GLOBAL_FLAGS.snapshot(),
               self.model.training, lr is None, self._lr_scaled,
               self._faults_armed, _obs.enabled())

        def first_call(count):
            with count():
                metrics = self._backend.warm_up(
                    lambda: self._step(args, labels, kwargs, lr))
            graph = _Graph(inputs)
            self._capture(graph, lr)
            self._graphs[key] = graph
            return metrics

        return _tracked(self, key, inputs, first_call)

    def _capture(self, graph: _Graph, lr) -> None:
        """Records the step over ``graph``'s buffers."""

        def body() -> None:
            graph.outputs = self._step(*graph.inputs, lr)

        # every leaf in at most one table (a flat fused master is one)
        _capture(self, graph, body, self.generator, len(self.params) + 1)

    def __call__(self, *args, labels=(), **kwargs) -> Dict[str,
                                                           torch.Tensor]:
        lr = self._lr()
        self._arm_faults()
        if not _obs.enabled():
            return self._run(args, _labels(labels), kwargs, lr)
        _register_probe_series()
        with _obs.span(self._span_name):
            metrics = self._run(args, _labels(labels), kwargs, lr)
        _obs.counter("optimizer_steps_total",
                     "optimizer update steps applied").inc()
        return self._drain_signals(metrics)

    # -- the probes' drain -------------------------------------------------

    def _drain_signals(self, metrics: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Takes the probe outputs off ``metrics``, queues them (a copy
        to pinned host memory behind an event on the card) and delivers
        what has completed."""
        nf = metrics.pop("_pt_nonfinite", None)
        gn = metrics.pop("_pt_gnorm", None)
        if gn is None:
            return metrics
        dev = torch.stack([torch.zeros_like(gn) if nf is None
                           else nf.to(gn.dtype), gn,
                           metrics["loss"].float()])
        ev = None
        if dev.is_cuda:
            host = torch.empty(3, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        else:
            host = dev
        self._pending_signals.append((host, ev, nf is not None))
        self.flush_signals(block=False)
        return metrics

    def flush_signals(self, block: bool = True) -> None:
        """Delivers queued probe signals, in step order, to their host
        handlers (the anomaly sentinel's ``loss`` and ``grad_norm``
        series, ``nonfinite_steps_total``). With ``block=False`` it
        stops at the first step whose copy has not completed
        (``event.query()``, no sync); with ``block`` it waits for each."""
        while self._pending_signals:
            host, ev, has_nf = self._pending_signals[0]
            if ev is not None and not ev.query():
                if not block:
                    return
                ev.synchronize()
            self._pending_signals.pop(0)
            nf, gn, loss = host.tolist()
            if has_nf:
                _note_nonfinite_host(bool(nf))
            sent = _obs.anomaly_sentinel()
            sent.observe("loss", float(loss))
            sent.observe("grad_norm", float(gn))

    def run_steps(self, *args, labels=(), **kwargs) -> Dict[str,
                                                            torch.Tensor]:
        """K steps over K stacked batches: every tensor of ``args``,
        ``labels`` and ``kwargs`` carries a leading axis K. The steps draw
        the same dropout streams as K calls, the rate's live host value
        (``host_lr``) is read once and held for the K steps, and the
        metrics come back stacked on a leading K axis
        (``metrics["loss"][-1]`` is the latest). Runs the K steps one by
        one, each as a call would (a replay when captured); the JAX
        package's one compiled scan is its speed, not its function."""
        labels = _labels(labels)
        first = _first_tensor((args, labels, kwargs))
        if first is None or first.ndim == 0:
            raise ValueError("run_steps needs batches stacked on a "
                             "leading steps axis")
        k = first.shape[0]
        lr = self._lr(scaled=False)
        self._arm_faults(enable=False)
        span = _obs.span(self._span_name + ".multi") \
            if _obs.enabled() else contextlib.nullcontext()
        with span:
            per = [self._drain_signals(
                self._run(_index(args, i), _index(labels, i),
                          _index(kwargs, i), lr)) for i in range(k)]
        if _obs.enabled():
            _obs.counter("optimizer_steps_total",
                         "optimizer update steps applied").inc(k)
        return {name: torch.stack([m[name] for m in per])
                for name in per[0]}

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

    def sync_to_model(self) -> None:
        """Flushes the pending probe signals (blocking). Otherwise a
        no-op: the step updates the model's own parameters in place, so
        the model holds the trained values after every step (the JAX
        step's donated state has to be written back)."""
        self.flush_signals()

    def state_dict(self) -> Dict[str, Any]:
        """The whole training state as one tree of the live tensors, with
        the JAX ``TrainStep.state``'s leaf paths (see the module note);
        ``generator`` is a copy of the generator's state."""
        tree = {"params": dict(self.model.named_parameters()),
                "buffers": dict(self.model.named_buffers()),
                "opt": self.state,
                "generator": self.generator.get_state()}
        if self.scaler_state is not None:
            tree["scaler"] = self.scaler_state
        return tree

    @torch.no_grad()
    def set_state_dict(self, state) -> None:
        """Restores a ``state_dict()`` tree, or ``io.load``'s flat dict of
        leaf paths (the port's checkpoint or the JAX package's), in place.
        Every parameter, buffer and optimizer leaf must be there with its
        shape and dtype (ValueError naming each one that is not, or that
        the step lacks); the scaler's are optional (a checkpoint without
        them keeps the step's). The generator takes ``generator``, else
        is seeded from a JAX ``rng`` key (:func:`seed_from_key_bits`),
        else keeps its state."""
        given = {k: v if isinstance(v, torch.Tensor) else
                 tensor_from_numpy(v) for k, v in _io.flatten(state).items()}
        gen = given.pop("generator", None)
        key = given.pop("rng", None)
        own = _io.flatten({k: v for k, v in self.state_dict().items()
                           if k != "generator"})
        missing = [k for k in own
                   if k not in given and not k.startswith("scaler/")]
        unexpected = [k for k in given if k not in own]
        wrong = [f"{k}: {tuple(given[k].shape)} {given[k].dtype} != "
                 f"{tuple(t.shape)} {t.dtype}" for k, t in own.items()
                 if k in given and (given[k].shape != t.shape
                                    or given[k].dtype != t.dtype)]
        if missing or unexpected or wrong:
            raise ValueError(f"TrainStep.set_state_dict: missing={missing} "
                             f"unexpected={unexpected} mismatched={wrong}")
        for k, t in own.items():
            if k in given:
                t.copy_(given[k])
        if gen is not None:
            self.generator.set_state(gen.to(torch.uint8).cpu())
        elif key is not None:
            self.generator.manual_seed(seed_from_key_bits(key))


class EvalStep:
    """Inference step: ``EvalStep(model, metric_fns)(params, buffers,
    *args, labels=())`` runs the model in eval mode without autograd and
    returns ``(outputs, {name: fn(outputs, *labels)})``. ``params`` /
    ``buffers`` (name -> tensor) replace the model's own for the call
    (``torch.func.functional_call``); None uses the model's. The model's
    training mode is restored after.

    ``compiled`` (None: the card captures, the CPU runs eagerly;
    ``compiled=True`` on the CPU raises) captures the forward and the
    metric functions as one CUDA graph per signature: the inputs' shapes,
    dtypes and other values, the ``params``/``buffers`` dicts' (copied
    into the graph's static buffers at each call) or None, the addresses
    of the model's own parameters and buffers (read where they are, so
    weights loaded in place are seen by the next replay, and replaced
    ones make a new signature), and every flag's value. The first call of
    a signature runs eagerly (the warm-up), under a check that no metric
    function synchronises with the host: one that does raises, naming
    it, as a capture cannot record it; nothing falls back to eager.
    Outputs come back as clones; the graphs are dropped with the step."""

    def __init__(self, model: nn.Module,
                 metric_fns: Optional[Dict[str, Callable]] = None,
                 compiled: Optional[bool] = None) -> None:
        self.model = model
        self.metric_fns = dict(metric_fns or {})
        first = next(iter(list(model.parameters())
                          + list(model.buffers())), None)
        self.device = torch.device("cpu") if first is None else first.device
        on_card = self.device.type == "cuda"
        if compiled and not on_card:
            raise ValueError(f"EvalStep(compiled=True) captures a CUDA "
                             f"graph, but the model is on {self.device}")
        self.compiled = on_card if compiled is None else bool(compiled)
        self._graphs: Dict[tuple, _Graph] = {}
        self._backend = _CudaGraphs(self.device) if self.compiled else None
        self.captures = 0
        self.capture_ms = 0.0
        self._carded: set = set()  # eager signatures with a program card
        self._span_name = f"EvalStep({type(model).__name__})"

    @torch.no_grad()
    def _step(self, params, buffers, args, labels, check_sync=False):
        """The forward and the metrics: what the eager step runs and the
        graph records; ``check_sync`` runs each metric under the
        backend's host-sync check."""
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
        metrics = {}
        for name, fn in self.metric_fns.items():
            check = self._backend.host_sync_check(f"EvalStep metric "
                                                  f"{name!r}") \
                if check_sync else contextlib.nullcontext()
            with check:
                metrics[name] = fn(out, *labels)
        return out, metrics

    def __call__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 buffers: Optional[Dict[str, torch.Tensor]] = None,
                 *args: Any, labels=()):
        labels = _labels(labels)
        span = _obs.span(self._span_name) if _obs.enabled() \
            else contextlib.nullcontext()
        with span:
            if not self.compiled:
                return _eager_carded(
                    self, (params, buffers, args, labels),
                    lambda: self._step(params, buffers, args, labels))
            return self._run(params, buffers, args, labels)

    def _run(self, params, buffers, args, labels):
        inputs = (params, buffers, args, labels)
        own = tuple(t.data_ptr() for t in list(self.model.parameters())
                    + list(self.model.buffers()))
        key = (_signature(inputs), own, GLOBAL_FLAGS.snapshot())

        def first_call(count):
            with count():
                result = self._backend.warm_up(
                    lambda: self._step(params, buffers, args, labels,
                                       check_sync=True))
            graph = _Graph(inputs)

            def body() -> None:
                graph.outputs = self._step(*graph.inputs)

            _capture(self, graph, body)
            self._graphs[key] = graph
            return result

        return _tracked(self, key, inputs, first_call)
