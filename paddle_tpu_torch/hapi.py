"""High-level Model API: ``Model.fit`` / ``evaluate`` / ``predict``.

Counterpart of ``paddle_tpu.hapi`` (``Callback``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRSchedulerCallback`` and
``Model`` with ``prepare``, ``train_batch``, ``fit``, ``evaluate``,
``predict_batch``, ``predict``, ``save``, ``load``, ``parameters`` and
``summary``), the same names, arguments and results. There is one path:
``static.TrainStep`` / ``static.EvalStep`` (captured as CUDA graphs on
the card, eager on the CPU), so ``fit`` is a thin loop: loader -> step
-> metrics/callbacks -> checkpoints.

Where the port differs from the JAX package, and why:

- **Batches reach the network's device.** JAX moves numpy implicitly;
  here a batch's numpy arrays become tensors (fp64 as fp32, as JAX takes
  them with x64 off), and when the network is on the card every loader
  of ``fit``/``evaluate``/``predict`` goes behind a
  ``data.DeviceLoader`` (pinned staging, copies on a side stream), the
  resume's ``iter_from`` re-entry included. A CPU network stays on the
  CPU; nothing falls back.
- **The network is always current.** The port's step updates the
  network's own parameters in place, so ``evaluate``/``predict`` read
  the network (``EvalStep`` with no substitute parameters) and
  ``sync_to_model`` only flushes the step's probe signals. A step is
  re-read from the network (``TrainStep.reset_from_model``, its graphs
  dropped) when a parameter's storage was replaced since it last ran.
- **Checkpoints** hold ``TrainStep.state_dict()`` (parameters, buffers,
  optimizer state, the step generator, the scaler: checkpoint v3, the
  JAX leaf paths) and are restored in place with ``set_state_dict``, so
  a captured step keeps its graphs.
- **Divergence rollback** drains the step's probe signals with
  ``TrainStep.flush_signals()`` where JAX calls
  ``jax.effects_barrier()``, so stale probes cannot re-trip the
  watchdog after the restore.

``prepare(mesh=...)`` routes ``fit`` to ``parallel.ShardedTrainStep``
over the mesh (its options pass through), every rank called with the
global batch, and with metrics on ``fit`` runs the straggler detector
(``observability.goodput.StragglerDetector``) over the data axis when it
has more than one rank. Not ported: the compile-cache flag (the port has
no compile cache).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import io as io_mod
from . import observability as _obs
from . import preemption as _preempt
from .data import DeviceLoader, _map
from .flags import GLOBAL_FLAGS
from .metric import Metric
from .optimizer import Optimizer
from .static import EvalStep, TrainStep
from .testing import faults as _faults

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRSchedulerCallback", "Model"]


class Callback:
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    """Prints the batch metrics every ``log_freq`` steps (a host sync
    then) and the epoch's means."""

    def __init__(self, log_freq: int = 10, verbose: int = 1) -> None:
        self.log_freq = log_freq
        self.verbose = verbose
        self._t0 = 0.0

    def on_epoch_begin(self, epoch, logs=None):
        self._t0 = time.perf_counter()
        self._epoch = epoch

    def on_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " ".join(f"{k}={float(v):.4f}"
                             for k, v in (logs or {}).items())
            print(f"[epoch {self._epoch} step {step}] {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.perf_counter() - self._t0
            items = " ".join(f"{k}={float(v):.4f}"
                             for k, v in (logs or {}).items())
            print(f"[epoch {epoch} done in {dt:.1f}s] {items}")


class ModelCheckpoint(Callback):
    """Saves the model every ``save_freq`` epochs under ``save_dir``."""

    def __init__(self, model: "Model", save_dir: str,
                 save_freq: int = 1) -> None:
        self.model = model
        self.save_dir = save_dir
        self.save_freq = save_freq

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/epoch-{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", patience: int = 3,
                 mode: str = "min") -> None:
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.best = None
        self.bad = 0
        self.stop_training = False

    def on_epoch_end(self, epoch, logs=None):
        val = float((logs or {}).get(self.monitor, np.nan))
        better = (self.best is None
                  or (self.mode == "min" and val < self.best)
                  or (self.mode == "max" and val > self.best))
        if better:
            self.best = val
            self.bad = 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                self.stop_training = True


class LRSchedulerCallback(Callback):
    """Feeds the epoch metric to a host-driven scheduler
    (``ReduceOnPlateau``); the step reads its new rate through
    ``host_lr`` at the next step, a captured one's next replay included.
    A scheduler computed on the device from the step counter needs no
    callback."""

    def __init__(self, optimizer: Optimizer,
                 monitor: str = "loss") -> None:
        self.optimizer = optimizer
        self.monitor = monitor

    def on_epoch_end(self, epoch, logs=None):
        sched = getattr(self.optimizer, "learning_rate", None)
        if getattr(sched, "host_driven", False):
            val = (logs or {}).get(self.monitor)
            if val is not None:
                sched.step(float(val))


def _ckpt_state_of(step) -> Optional[Dict]:
    """The checkpointable state of a train step: the whole training state
    (``TrainStep.state_dict()``: parameters, buffers, optimizer state,
    the step generator and the scaler's state), so a resumed run goes on
    bit for bit; None for a step without one."""
    state_dict = getattr(step, "state_dict", None)
    return state_dict() if callable(state_dict) else None


def _fit_host_state(global_step: int, epoch: int,
                    batch_in_epoch: int) -> Dict:
    """The manifest's host_state of a fit checkpoint: where in the data
    stream the save landed."""
    return {"global_step": int(global_step), "epoch": int(epoch),
            "batch_in_epoch": int(batch_in_epoch)}


def _parse_amp(amp):
    """``fit(amp=...)`` -> ``(amp dtype name, GradScaler | None)``: fp16
    gets the dynamic loss scaler, bf16 the skip-step guard alone; a
    GradScaler instance implies fp16."""
    from . import amp as amp_mod
    from .core.dtype import convert_dtype
    if amp is None or amp is False:
        return None, None
    if isinstance(amp, amp_mod.GradScaler):
        return "float16", amp
    if amp is True:
        amp = "bfloat16"
    dtype = convert_dtype(amp)
    if dtype == torch.float16:
        return "float16", amp_mod.GradScaler()
    if dtype == torch.bfloat16:
        return "bfloat16", None
    raise ValueError(
        "fit(amp=...) expects 'float16'/'bfloat16' (or a GradScaler "
        f"instance), got {amp!r}")


def _as_metric_list(metrics) -> List[Metric]:
    if metrics is None:
        return []
    if isinstance(metrics, Metric):
        return [metrics]
    return list(metrics)


def _as_tensors(tree):
    """Every numpy array (or numpy scalar) of a batch as a CPU tensor,
    fp64 as fp32; tensors as they are."""
    if isinstance(tree, (np.ndarray, np.generic)):
        a = np.asarray(tree)
        return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                                else np.ascontiguousarray(a))
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return tree


def _to(tree, device: torch.device):
    """A batch's tensors on ``device``."""
    return _map(lambda t: t.to(device), _as_tensors(tree))


def _host(out):
    """A forward's output as numpy (a tuple of outputs as a tuple)."""
    if isinstance(out, torch.Tensor):
        t = out.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(out, (list, tuple)):
        return type(out)(_host(v) for v in out) \
            if not hasattr(out, "_fields") else type(out)(*map(_host, out))
    return np.asarray(out)


class Model:
    """A network with its loss, optimizer and metrics, trained by
    ``fit``, scored by ``evaluate`` and run by ``predict``."""

    def __init__(self, network: nn.Module, loss: Optional[Callable] = None,
                 optimizer: Optional[Optimizer] = None,
                 metrics: Optional[Sequence[Metric]] = None) -> None:
        self.network = network
        self._loss = loss
        self._optimizer = optimizer
        self._metrics = _as_metric_list(metrics)
        self._train_step: Optional[TrainStep] = None
        self._step_storage: tuple = ()
        self._eval_step: Optional[EvalStep] = None
        self._fitting = False
        self._amp_dtype = None
        self._scaler = None
        self._mesh = None
        self._mesh_kwargs: Dict = {}

    def prepare(self, optimizer: Optional[Optimizer] = None,
                loss: Optional[Callable] = None,
                metrics: Optional[Sequence[Metric]] = None,
                mesh=None, **mesh_kwargs) -> "Model":
        """Sets the optimizer, the loss and the metrics. With ``mesh=``
        fit trains distributed: a ``parallel.ShardedTrainStep`` over the
        mesh, the other keywords (``batch_spec``, ``param_rule``,
        ``zero_stage``, ``dp_axis``, ``seed``) passed through to it."""
        allowed = {"batch_spec", "param_rule", "zero_stage", "dp_axis",
                   "seed"}
        unknown = set(mesh_kwargs) - allowed
        if unknown or (mesh_kwargs and mesh is None):
            raise TypeError(
                f"prepare() got unexpected keyword arguments "
                f"{sorted(unknown or mesh_kwargs)}; mesh options "
                f"({sorted(allowed)}) require mesh=")
        if mesh is not None:
            self._mesh = mesh
            self._mesh_kwargs = dict(mesh_kwargs)
            self._train_step = None
        if optimizer is not None:
            self._optimizer = optimizer
        if loss is not None:
            self._loss = loss
        if metrics is not None:
            self._metrics = _as_metric_list(metrics)
        return self

    # -- devices and feeds --------------------------------------------------

    def _device(self) -> torch.device:
        first = next(iter(list(self.network.parameters())
                          + list(self.network.buffers())), None)
        return torch.device("cpu") if first is None else first.device

    def _feed(self, batches):
        """An iterator of ``batches`` as batches of tensors on the
        network's device: behind a ``DeviceLoader`` on the card,
        converted in place on the CPU."""
        dev = self._device()
        if dev.type != "cuda":
            return (_to(b, dev) for b in batches)
        return iter(DeviceLoader((_as_tensors(b) for b in batches),
                                 device=dev))

    # -- the steps ----------------------------------------------------------

    def _storage(self) -> tuple:
        return tuple((n, p.data_ptr())
                     for n, p in self.network.named_parameters())

    def _get_train_step(self) -> TrainStep:
        if self._train_step is None:
            loss_fn = self._loss
            if isinstance(loss_fn, nn.Module):
                fn = loss_fn

                def loss_call(out, *labels):
                    return fn(out, *labels)
            else:
                loss_call = loss_fn
            extra = {}
            for m in self._metrics:
                if hasattr(m, "compute") and hasattr(m, "topk"):
                    # inside the captured step: the tie-exact top-1 of
                    # ops.metrics_ops, no host value
                    from .ops.metrics_ops import accuracy as acc_fn
                    extra["acc"] = (lambda out, *ls: acc_fn(out, ls[0]))
            if self._mesh is not None:
                from .parallel import ShardedTrainStep
                self._train_step = ShardedTrainStep(
                    self.network, self._optimizer, loss_call, self._mesh,
                    extra_metrics=extra, amp_dtype=self._amp_dtype,
                    scaler=self._scaler, **self._mesh_kwargs)
            else:
                self._train_step = TrainStep(
                    self.network, self._optimizer, loss_call,
                    extra_metrics=extra, amp_dtype=self._amp_dtype,
                    scaler=self._scaler)
            self._step_storage = self._storage()
        return self._train_step

    def _refresh_step(self) -> None:
        """Re-reads the network into the step when a parameter's storage
        changed since the step last saw it (weights set by replacing
        ``.data``, or a new parameter): the graphs would read the old."""
        if self._train_step is not None \
                and self._storage() != self._step_storage:
            self._train_step.reset_from_model()
            self._step_storage = self._storage()

    def train_batch(self, inputs, labels) -> Dict[str, float]:
        step = self._get_train_step()
        dev = self._device()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        inputs = [_to(x, dev) for x in inputs]
        labels = tuple(_to(y, dev) for y in labels)
        if not self._fitting:
            self._refresh_step()
        try:
            metrics = step(*inputs, labels=labels)
        finally:
            if not self._fitting:
                step.sync_to_model()
        return {k: float(v) for k, v in metrics.items()}

    def fit(self, train_loader, eval_loader=None, epochs: int = 1,
            callbacks: Optional[List[Callback]] = None,
            verbose: int = 1, log_freq: int = 10,
            ckpt_dir: Optional[str] = None, save_steps: int = 0,
            ckpt_max_to_keep: int = 3,
            amp=None) -> Dict[str, List[float]]:
        """Trains; returns the per-epoch history ``{metric: [epoch 0,
        ...]}``.

        With ``ckpt_dir=`` fit is fault-tolerant at step granularity: an
        ``io.AsyncCheckpointer`` saves the whole training state every
        ``save_steps`` steps (and once at the end), and a fresh fit over
        the same directory restores the newest intact checkpoint in
        place and re-enters the data stream at the saved offset
        (``DataLoader.iter_from``; a loader without one is replayed past
        it), bit for bit the uninterrupted run. SIGTERM is caught by a
        preemption guard: the step in flight finishes, a final
        synchronous checkpoint is written at it, and the signal is
        re-raised so the process still dies with the SIGTERM status.

        ``amp='float16'`` puts ``amp.GradScaler``'s dynamic loss scaling
        into the step; ``amp='bfloat16'`` runs the forward under bf16
        autocast with the skip-step guard alone.

        Divergence rollback: with metrics on and ``ckpt_dir`` set, a
        watchdog fed by the step's loss probes rolls fit back to the
        newest intact checkpoint after FLAGS_divergence_streak anomalous
        losses in a row, at most FLAGS_rollback_budget times, rescaling
        the rate by FLAGS_rollback_lr_factor at each re-entry."""
        callbacks = list(callbacks or [])
        if amp is not None:
            from . import amp as amp_mod
            amp_dtype, scaler = _parse_amp(amp)
            changed = (amp_dtype != self._amp_dtype
                       or (scaler is None) != (self._scaler is None)
                       or (isinstance(amp, amp_mod.GradScaler)
                           and scaler is not self._scaler))
            if changed:
                # the step holds the AMP policy: rebuild it (the optimizer
                # state restarts unless a checkpoint restores it)
                self._amp_dtype, self._scaler = amp_dtype, scaler
                self._train_step = None
        if verbose:
            callbacks.append(ProgBarLogger(log_freq, verbose))
        if self._optimizer is not None and not any(
                isinstance(cb, LRSchedulerCallback) for cb in callbacks):
            if getattr(getattr(self._optimizer, "learning_rate", None),
                       "host_driven", False):
                callbacks.append(LRSchedulerCallback(self._optimizer))
        history: Dict[str, List[float]] = {}
        # the JAX package applies its persistent compile cache here; the
        # port has none (ROADMAP A17)
        _obs.server.maybe_start()
        ledger = _obs.goodput_ledger()
        if _obs.enabled():
            ledger.start()
            _obs.flight.install()
            _obs.flight.record("fit_begin", epochs=epochs)
        self._refresh_step()
        guard = _preempt.guard()
        guard.__enter__()
        preempted = False
        watchdog = None
        self._fitting = True
        try:
            for cb in callbacks:
                cb.on_train_begin()
            step = self._get_train_step()
            ckptr = None
            resume_step = 0
            if ckpt_dir:
                if _ckpt_state_of(step) is None:
                    raise ValueError(
                        "fit(ckpt_dir=...) needs a train step with a "
                        f"state_dict() (got {type(step).__name__})")
                ckptr = io_mod.AsyncCheckpointer(
                    ckpt_dir, max_to_keep=ckpt_max_to_keep)
                restored, at = ckptr.restore_latest()
                if restored is not None:
                    step.set_state_dict(restored)
                    resume_step = int(at or 0)
                    _obs.flight.record("fit_resume", force=True,
                                       step=resume_step)
            straggler = None
            if _obs.enabled():
                mesh = getattr(step, "mesh", None)
                axis = getattr(step, "axis", "dp")
                if mesh is not None and axis in mesh.shape \
                        and mesh.shape[axis] > 1:
                    straggler = _obs.goodput.StragglerDetector(mesh, axis)
            if ckptr is not None and _obs.enabled() \
                    and int(GLOBAL_FLAGS.get("rollback_budget")) > 0:
                # fed by the loss probes the step already hands to the
                # anomaly sentinel: no extra sync, no extra probe
                watchdog = _obs.anomaly.DivergenceWatchdog().attach(
                    _obs.anomaly.sentinel())
            rollbacks = 0
            global_step = 0
            epoch = 0
            i = -1
            # while, not for: a rollback rewinds `epoch` and replays from
            # the restored step
            while epoch < epochs:
                rollback = False
                for cb in callbacks:
                    cb.on_epoch_begin(epoch)
                # the hot loop syncs nothing per step: the metrics stay
                # device tensors (a callback that float()s them syncs when
                # it does) and the epoch means are read once at its end
                totals: Dict[str, torch.Tensor] = {}
                count = 0
                logs: Dict[str, float] = {}
                obs_on = _obs.enabled()
                if obs_on:
                    step_hist = _obs.histogram(
                        "hapi_step_time_seconds",
                        "fit() per-step wall time (dispatch, not sync)")
                    tput_g = _obs.gauge(
                        "hapi_throughput_items_per_sec",
                        "items/s of the latest fit() step")
                    loss_g = _obs.gauge(
                        "hapi_loss",
                        "latest training loss (held as a device tensor; "
                        "synced only at snapshot time)")
                    mem_g = _obs.gauge(
                        "device_mem_bytes_in_use",
                        "per-device allocator true-peak watermark "
                        "(peak_bytes_in_use where the backend reports "
                        "it, else the bytes_in_use high-water mark)")
                    headroom_g = _obs.gauge(
                        "memory_headroom_bytes",
                        "per-device bytes_limit - bytes_in_use (absent "
                        "on backends without an allocator limit)")
                    hb_g = _obs.gauge(
                        _obs.server.HEARTBEAT_GAUGE,
                        "unix time of the latest completed fit() step "
                        "dispatch; /healthz flags staleness")
                    flops_g = _obs.gauge(
                        "achieved_flops_per_sec",
                        "program-card FLOPs of the captured train step "
                        "divided by measured step wall time")
                    scale_g = _obs.gauge(
                        "amp_loss_scale",
                        "current GradScaler dynamic loss scale "
                        "(fp16 AMP; held as a device tensor, synced "
                        "only at snapshot time)") \
                        if step.scaler_state is not None else None
                source = train_loader
                i = -1
                skip = resume_step - global_step
                if skip > 0 and hasattr(train_loader, "iter_from"):
                    # re-enter the data stream at the saved batch without
                    # fetching the skipped ones (the sampler is still
                    # drawn, so a seeded shuffle replays its order)
                    try:
                        n_epoch = len(train_loader)
                    except TypeError:
                        n_epoch = None
                    if n_epoch:
                        take = min(skip, n_epoch)
                        source = train_loader.iter_from(take)
                        global_step += take
                        i = take - 1
                batches = self._feed(source)
                while True:
                    if _faults.active() and global_step >= resume_step:
                        _faults.hit("loader", step=global_step)
                    if obs_on:
                        # blocking on the pipeline is data_wait badput
                        t_wait = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        break
                    if obs_on:
                        ledger.attribute("data_wait",
                                         time.perf_counter() - t_wait)
                    i += 1
                    *inputs, label = batch
                    if global_step < resume_step:
                        # resume fast-forward: replay the stream past the
                        # restored step without compute or callbacks
                        global_step += 1
                        continue
                    if _faults.active():
                        _faults.set_step_context(global_step)
                        _faults.hit("train_step", step=global_step)
                        _faults.hit("sigterm", step=global_step)
                    if obs_on:
                        compile_before = _obs.goodput.compile_seconds_total()
                        cache_before = _obs.goodput.compile_cache_stats()
                        t0 = time.perf_counter()
                    metrics = step(*inputs, labels=(label,))
                    if obs_on:
                        # host-side accounting only: the loss gauge keeps
                        # the device tensor, the memory stats read the
                        # allocator, never the stream
                        dt = time.perf_counter() - t0
                        # a call that captured spent its time in the
                        # warm-up and the capture: the compile bucket
                        compile_dt = min(dt, max(
                            0.0,
                            _obs.goodput.compile_seconds_total()
                            - compile_before))
                        if compile_dt > 0:
                            ledger.attribute(
                                _obs.goodput.classify_compile_bucket(
                                    cache_before), compile_dt)
                        ledger.attribute("step_compute", dt - compile_dt)
                        _obs.flight.record("step", epoch=epoch, step=i)
                        if straggler is not None:
                            straggler.observe(global_step, dt)
                        step_hist.observe(dt)
                        items = int(label.shape[0]) \
                            if getattr(label, "ndim", 0) else 1
                        tput_g.set(items / dt if dt > 0 else 0.0)
                        loss_g.set(metrics.get("loss"))
                        if scale_g is not None:
                            scale_g.set(step.scaler_state["scale"])
                        hb_g.set(time.time())
                        for dev, ms in _obs.device_memory_stats(
                                include_unavailable=True,
                                full=True).items():
                            mem_g.set_max(
                                ms["peak_bytes_in_use"]
                                or ms["bytes_in_use"], device=dev)
                            if ms["bytes_limit"]:
                                headroom_g.set(
                                    ms["bytes_limit"]
                                    - ms["bytes_in_use"], device=dev)
                        flops = _obs.xprof.flops_of(step._span_name)
                        if flops and dt > 0:
                            flops_g.set(flops / dt)
                    for k, v in metrics.items():
                        # a running device sum: no host sync
                        totals[k] = v if k not in totals else totals[k] + v
                    count += 1
                    for cb in callbacks:
                        cb.on_batch_end(i, metrics)
                    global_step += 1
                    if ckptr is not None and save_steps > 0 \
                            and global_step % save_steps == 0:
                        ckptr.save(_ckpt_state_of(step),
                                   step=global_step,
                                   host_state=_fit_host_state(
                                       global_step, epoch, i))
                        _obs.flight.record("checkpoint_save",
                                           step=global_step)
                    if guard.preempted:
                        # the step is done: leave both loops for the
                        # final checkpoint below
                        preempted = True
                        break
                    if watchdog is not None and watchdog.tripped():
                        rollback = True
                        break
                batches.close()
                if preempted:
                    break
                if rollback:
                    budget = int(GLOBAL_FLAGS.get("rollback_budget"))
                    rollbacks += 1
                    _obs.counter(
                        "rollbacks_total",
                        "divergence-watchdog checkpoint rollbacks "
                        "performed by Model.fit", always=True).inc()
                    _obs.flight.record("fit_rollback", force=True,
                                       at_step=global_step,
                                       n=rollbacks)
                    if rollbacks > budget:
                        raise FloatingPointError(
                            f"training diverged again after {budget} "
                            "rollback(s) — FLAGS_rollback_budget "
                            "exhausted; newest intact checkpoint is "
                            f"step {ckptr.latest_step()}")
                    # deliver the probes still in flight, so stale
                    # pre-rollback anomalies cannot re-trip the fresh
                    # watchdog state
                    step.flush_signals()
                    restored, at = ckptr.restore_latest()
                    if restored is None:
                        raise FloatingPointError(
                            "training diverged and no intact "
                            "checkpoint exists to roll back to "
                            f"(ckpt_dir={ckpt_dir!r})")
                    step.set_state_dict(restored)
                    resume_step = int(at or 0)
                    global_step = 0
                    factor = float(
                        GLOBAL_FLAGS.get("rollback_lr_factor"))
                    if factor != 1.0:
                        # through host_lr: the step's graph is reused
                        step.lr_scale = step.lr_scale * factor
                    _obs.anomaly.sentinel().reset()
                    watchdog.reset()
                    _obs.flight.record(
                        "fit_rollback_resume", force=True,
                        resume_step=resume_step, lr_scale=step.lr_scale)
                    epoch = 0
                    continue
                logs = {k: float(v) / max(count, 1)
                        for k, v in totals.items()}
                if eval_loader is not None:
                    with ledger.measure("eval"):
                        logs.update(self.evaluate(eval_loader, verbose=0))
                if obs_on:
                    ledger.publish()
                for k, v in logs.items():
                    history.setdefault(k, []).append(v)
                for cb in callbacks:
                    cb.on_epoch_end(epoch, logs)
                if any(getattr(cb, "stop_training", False)
                       for cb in callbacks):
                    break
                epoch += 1
            if preempted:
                _obs.flight.record("preempted", force=True,
                                   step=global_step)
                if ckptr is not None:
                    # a final SYNCHRONOUS checkpoint: resume from the step
                    # the preemption landed on
                    try:
                        ckptr.save(_ckpt_state_of(step),
                                   step=global_step,
                                   host_state=_fit_host_state(
                                       global_step, epoch, i))
                        ckptr.wait()
                        _obs.flight.record("preempt_checkpoint",
                                           force=True, step=global_step)
                    except Exception as e:  # noqa: BLE001
                        # the signal is re-raised below whatever happened;
                        # the failure stays in the flight record
                        _obs.flight.record("preempt_checkpoint_failed",
                                           force=True, step=global_step,
                                           error=str(e)[:300])
                guard.reraise()  # dies with the SIGTERM wait status
            for cb in callbacks:
                cb.on_train_end()
            if ckptr is not None:
                # the end state durable before fit returns, unless the
                # cadence just wrote this very step
                if save_steps <= 0 or global_step % save_steps != 0:
                    ckptr.save(_ckpt_state_of(step), step=global_step,
                               host_state=_fit_host_state(
                                   global_step, epoch, i))
                ckptr.wait()
            if _obs.enabled():
                _obs.flight.record("fit_end", steps_run=global_step)
                ledger.stop()
                ledger.publish()
                if GLOBAL_FLAGS.get("trace_dir"):
                    _obs.export_all()
        finally:
            guard.__exit__(None, None, None)
            self._fitting = False
            if watchdog is not None:
                watchdog.detach(_obs.anomaly.sentinel())
            if _faults.active():
                _faults.set_step_context(None)
            if ledger.running():  # an interrupted fit: close the books
                ledger.stop()
            if self._train_step is not None:
                self._train_step.sync_to_model()
        return history

    def _get_eval_step(self) -> EvalStep:
        if self._eval_step is None:
            self._eval_step = EvalStep(self.network)
        return self._eval_step

    def evaluate(self, eval_loader, verbose: int = 1) -> Dict[str, float]:
        """``{"eval_loss": mean of the batch losses, "eval_<metric>":
        ...}``. No host sync per batch: the losses stay device tensors
        (read once at the end) and a metric's ``compute`` outputs are
        kept and given to ``update`` after the last batch; a metric
        without ``compute`` updates per batch."""
        if verbose:
            print("Eval begin...")
        ev = self._get_eval_step()
        for m in self._metrics:
            m.reset()
        losses = []
        pending: List[tuple] = []
        for batch in self._feed(eval_loader):
            *inputs, label = batch
            out, _ = ev(None, None, *inputs)
            with torch.no_grad():
                if self._loss is not None:
                    losses.append(self._loss(out, label))
                for m in self._metrics:
                    if hasattr(m, "compute"):
                        pending.append((m, m.compute(out, label)))
                    else:
                        m.update(out, label)
        result = {}
        if losses:
            result["eval_loss"] = float(torch.stack(
                [v.float() for v in losses]).mean())
        for m, computed in pending:
            m.update(computed)
        for m in self._metrics:
            result[f"eval_{m.name()}"] = m.accumulate()
        if verbose:
            def _fmt(v):
                try:
                    return f"{v:.4f}"
                except (TypeError, ValueError):  # list-valued metrics
                    return str(v)
            print("Eval done: " + " - ".join(
                f"{k}: {_fmt(v)}" for k, v in result.items()))
        return result

    def predict_batch(self, inputs):
        """The network's eval forward on one batch (its device tensors)."""
        dev = self._device()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        out, _ = self._get_eval_step()(None, None,
                                       *[_to(x, dev) for x in inputs])
        return out

    def predict(self, loader) -> List:
        """One numpy output per batch. Lag one: batch N is read to the
        host after batch N+1 was launched, so the copy overlaps compute
        and one batch's output at a time stays on the device."""
        results: List = []
        pending = None
        for b in self._feed(loader):
            out = self.predict_batch(list(b)[:-1]
                                     if isinstance(b, tuple) else b)
            if pending is not None:
                results.append(_host(pending))
            pending = out
        if pending is not None:
            results.append(_host(pending))
        return results

    def save(self, path: str, training: bool = True,
             input_spec=None) -> None:
        """``training=True``: the network's state dict to
        ``<path>.pdparams`` (checkpoint v3, readable by the JAX
        package). ``training=False``: the inference export
        (``jit.save``, eval mode, for ``inference.create_predictor``)."""
        if self._fitting and self._train_step is not None:
            self._train_step.sync_to_model()
        with _obs.goodput_ledger().measure("checkpoint"):
            if not training:
                from . import jit as jit_mod
                jit_mod.save(self.network, path, input_spec=input_spec)
                return
            io_mod.save(self.network.state_dict(), path + ".pdparams")

    def load(self, path: str) -> None:
        """Loads ``<path>.pdparams`` (the port's or the JAX package's)
        into the network in place, keys not in it ignored; the steps are
        rebuilt at their next use (the optimizer state restarts)."""
        state = io_mod.load(path + ".pdparams")
        self.network.load_state_dict(
            {k.replace("/", "."): v for k, v in state.items()},
            strict=False)
        self._train_step = None
        self._eval_step = None

    def parameters(self):
        return list(self.network.parameters())

    def summary(self) -> str:
        lines = ["Layer (type)                 Param #"]
        total = 0
        for name, p in self.network.named_parameters():
            n = p.numel()
            total += n
            lines.append(f"{name:<30} {n}")
        lines.append(f"Total params: {total}")
        out = "\n".join(lines)
        print(out)
        return out
