"""Optimizers: the ``Optimizer`` base, SGD / Momentum, Adam / AdamW and
the rest of the family as Paddle computes them.

Counterpart of ``paddle_tpu.optimizer``: ``Optimizer``, ``SGD``,
``Momentum``, ``Adam``, ``AdamW``, ``LarsMomentum``, ``Adamax``,
``Adagrad``, ``Adadelta``, ``RMSProp``, ``Lamb``, ``Ftrl``, ``Dpsgd``,
``DecayedAdagrad``, ``ProximalGD``, ``ProximalAdagrad``, the
``*Optimizer`` spellings, and the wrappers of ``optimizer.extras``
(``ExponentialMovingAverage``, ``ModelAverage``, ``Lookahead``,
``GradientMerge``). Each update is the JAX one, in place under the skip
guard's ``ok``. Those that are elementwise (SGD, Momentum, Adam(W),
Adamax, Adagrad, Adadelta, RMSProp) may run on the flat fused state;
the rest (a norm per leaf, or per-leaf state the JAX package keeps per
leaf) run per leaf, ``fused_state`` or not. ``SGD`` is ``p - lr g``;
``Momentum`` keeps a ``velocity`` slot, ``v = mu v + g``, and steps
``p - lr v`` (``p - lr (g + mu v)`` with ``use_nesterov``), as
``momentum_op`` does; both are elementwise, so both run on the flat
fused state too. Paddle's Adam is not ``torch.optim.Adam``: ``eps`` is added
to the UNCORRECTED ``sqrt(v)``, and the bias correction is folded into
the learning rate,

    m = b1 m + (1 - b1) g,   v = b2 v + (1 - b2) g^2,
    lr_c = lr sqrt(1 - b2^t) / (1 - b1^t),
    p = p - lr_c m / (sqrt(v) + eps),

and AdamW's decoupled decay then subtracts ``lr * wd * p_old`` with the
UNCORRECTED ``lr`` (skipped for parameters whose name
``apply_decay_param_fun`` rejects). ``Adam(weight_decay=c)`` is coupled
L2 (``g + c p``), as there; ``weight_decay`` may also be a regularizer
(``regularizer.L1Decay``/``L2Decay``), and a parameter's own
``regularizer`` attribute (wired by ``static.TrainStep``) replaces it
for that parameter.

The functional API is the JAX package's: ``init(params)`` builds the
state for a name-keyed dict of parameters, and ``apply_gradients(params,
grads, state, ok, lr_override)`` updates them. Here the update is IN
PLACE on the parameter and state tensors, the step counter included (no
second copy of the model, and a CUDA graph of the step reads every state
tensor where it was captured);
the step counter is a device tensor, and ``ok`` (a 0-d bool device
tensor) selects between the new and the old values on the device, so a
train step's skip guard costs no host sync. The learning rate is a float
or a scheduler (``optimizer.lr``) evaluated on the device step counter;
``lr_override`` (a host-driven scheduler's live value) replaces it.

Mixed precision, as in the JAX package (master weights):

- the moments ``m``/``v`` are fp32 whatever the parameter's dtype,
  stored in ``optimizer_moment_dtype`` (fp32, or bf16 with the math
  still in fp32), read at ``init``;
- a bf16/fp16 parameter gets a persistent fp32 ``master`` in its slots;
  the update reads and writes the master, and the parameter is then
  rewritten as the master cast down (an update below half a bf16 ulp
  accumulates in the master instead of being lost);
- gradients are cast up to fp32 first, then ``grad_clip`` runs on them,
  then the coupled decay or the parameter's regularizer.

``fused_state`` (or the ``optimizer_fused_state`` flag) packs the state
of every floating parameter into flat fp32 vectors ``m``, ``v`` and
``master``, in the JAX package's leaf order (sorted by name): one update
over the flat master per step, each parameter then rewritten from its
slice. A parameter without a gradient is an exact no-op (its slices of
the master and the moments are put back after the update). Per-parameter
regularizers and ``apply_decay_param_fun`` raise under it, as there.

The fused routes, under the JAX package's conditions applied to the
fp32 master (or the fp32 parameter) and the moments: with the
``fused_adam`` flag every leaf whose master and moments are fp32 takes
the leaf variant of the Adam kernel; else, with ``use_pallas_adam``,
every leaf whose master and ``m`` are fp32 and that has at least 1024
elements takes its flat variant. Each route updates all its leaves of a
step in one ``kernels.maybe_fused_adam`` call (one launch on the card,
the plain version on the CPU; one leaf, the flat master, under
``fused_state``), AdamW's decay and the skip guard folded in; the other
leaves (bf16 moments among them) take the unfused update, fp32 math
with the moments stored back in their dtype.

A gradient may be an ``ops.sparse.RowSlices`` (an embedding's
``embedding_grad``), as in the JAX package: ``update_sparse`` takes it.
The base class densifies it (``to_dense``) and runs the dense update;
``SGD`` and ``Adam(lazy_mode=True)`` read and write the touched rows
alone (the moments of the other rows stay as they were), after
``merge_rows`` has summed duplicate rows, as the reference's sparse
functors merge them. Each row is written with its new value
(``index_copy_``), so a touched row equals the dense update's bit for
bit. A sparse gradient's values join ``grad_clip`` (its norm, and the
scale or clamp) and it takes no weight decay (under ``fused_state`` it
is densified into the flat update, its slice undecayed), as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from .. import kernels
from ..core import random as _random
from ..flags import GLOBAL_FLAGS
from ..kernels import fused_adam as _adam
from ..ops.sparse import RowSlices, merge_rows, to_dense
from . import lr
from .lr import LRScheduler, resolve_lr

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "LarsMomentum",
           "Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb", "Ftrl",
           "Dpsgd", "DecayedAdagrad", "ProximalGD", "ProximalAdagrad",
           "AdamOptimizer", "SGDOptimizer", "MomentumOptimizer",
           "AdamaxOptimizer", "AdagradOptimizer", "AdadeltaOptimizer",
           "RMSPropOptimizer", "LambOptimizer", "FtrlOptimizer",
           "LarsMomentumOptimizer", "ExponentialMovingAverage",
           "ModelAverage", "Lookahead", "GradientMerge", "LRScheduler",
           "lr"]

# the use_pallas_adam route's least leaf size (the JAX package's)
_FLAT_MIN_NUMEL = 1024
_LOW = (torch.bfloat16, torch.float16)


def _moment_dtype(default: torch.dtype) -> torch.dtype:
    """The moments' storage dtype: ``optimizer_moment_dtype`` bfloat16,
    else ``default``; any other value raises (a typo would silently
    measure the fp32 baseline)."""
    val = GLOBAL_FLAGS.get("optimizer_moment_dtype")
    if val == "bfloat16":
        return torch.bfloat16
    if val != "float32":
        raise ValueError(f"optimizer_moment_dtype={val!r}: expected "
                         f"'float32' or 'bfloat16'")
    return default


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    """A bf16/fp16 tensor cast up to fp32; any other as it is."""
    return t.float() if t.dtype in _LOW else t


def _g32(g):
    """A gradient cast up to fp32 (a RowSlices' values)."""
    if g is None:
        return None
    if isinstance(g, RowSlices):
        return RowSlices(g.rows, _as_f32(g.values), g.dense_rows)
    return _as_f32(g)


class _Rows(NamedTuple):
    """The rows a sparse update touches: ``rows`` (int64, each real row
    once; the slots ``merge_rows`` frees repeat the first row), the
    merged ``values`` and the ``valid`` slots."""
    rows: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor


def _touched(g: RowSlices) -> _Rows:
    m = merge_rows(g)
    valid = m.rows < g.dense_rows
    return _Rows(torch.where(valid, m.rows, m.rows[:1]), m.values, valid)


def _write_rows(t: torch.Tensor, r: _Rows, new: torch.Tensor,
                ok: Optional[torch.Tensor]) -> None:
    """Rows ``r.rows`` of ``t`` set to ``new`` in place (the old rows
    where ``ok`` is False). A freed slot writes its row's own new value
    (slot 0's), so the repeated index writes one value."""
    valid = r.valid.reshape((-1,) + (1,) * (new.ndim - 1))
    new = torch.where(valid, new, new[:1])
    if ok is not None:
        new = torch.where(ok, new, t[r.rows])
    t.index_copy_(0, r.rows, new.to(t.dtype))


class _Leaf(NamedTuple):
    """One tensor the update writes: ``p32`` (the fp32 master, or the
    parameter itself), its fp32 gradient and its slots (``m``, ``v``);
    ``name`` None for the flat fused master."""
    name: Optional[str]
    p32: torch.Tensor
    g: torch.Tensor
    slots: Dict[str, torch.Tensor]


class Optimizer:
    """Base optimizer: ``state = opt.init(params)``, then
    ``opt.apply_gradients(params, grads, state, ok, lr_override)`` per
    step (see the module note). Subclasses give ``init_slots`` and
    ``_update`` (one in-place update of a list of :class:`_Leaf`)."""

    # elementwise updates may run on the flat fused state
    _elementwise_update = False

    def __init__(self, learning_rate=0.001, weight_decay=None,
                 grad_clip=None, fused_state: Optional[bool] = None) -> None:
        self.learning_rate = learning_rate
        # a coefficient, or a regularizer called as reg(param, grad)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self._fused_state = fused_state
        # {name: (need_clip, regularizer)} (set_param_meta)
        self._param_meta: Dict[str, tuple] = {}
        self._eager_state: Optional[dict] = None

    def get_lr(self) -> float:
        """The current rate as a host float: a scheduler's ``get_lr()``,
        else the float itself."""
        if isinstance(self.learning_rate, LRScheduler):
            return self.learning_rate.get_lr()
        return float(self.learning_rate)

    def set_lr(self, value: float) -> None:
        """Replaces the rate with ``value``. ``static.TrainStep`` reads a
        float rate into its ``host_lr`` before each step, so the new rate
        takes effect at the next step, a captured one's next replay
        included."""
        self.learning_rate = value

    def state_dict(self) -> dict:
        """The state set by :meth:`set_state_dict`, else ``{}``, as in the
        JAX package: the state a train step updates is ``init``'s tree,
        held by the step (``TrainStep.state``; its ``state_dict()`` is
        the checkpointable whole)."""
        return self._eager_state or {}

    def set_state_dict(self, state) -> None:
        self._eager_state = state

    def set_param_meta(self, meta) -> None:
        """Per-parameter metadata ``{name: (need_clip, regularizer)}``:
        need_clip False keeps that gradient out of ``grad_clip``; a
        regularizer replaces ``weight_decay`` for that parameter."""
        self._param_meta = dict(meta)

    def _decay_grad(self, g, p32, reg=None):
        """``g`` with weight decay: the parameter's regularizer if set,
        else ``weight_decay`` (a coefficient, or a regularizer called as
        ``reg(param, grad)``)."""
        wd = reg if reg is not None else self.weight_decay
        if not wd:
            return g
        if callable(wd):
            return wd(p32, g)
        return g + wd * p32

    def _use_fused(self) -> bool:
        if not self._elementwise_update:
            return False
        if self._fused_state is not None:
            return bool(self._fused_state)
        return bool(GLOBAL_FLAGS.get("optimizer_fused_state"))

    def init_slots(self, p32: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        """The state of ``params`` (name -> tensor): ``step`` (int32 on
        their device) and per-parameter ``slots``, with ``master`` for a
        bf16/fp16 parameter; under ``fused_state`` the flat ``fused``
        slots instead, and empty per-parameter slots."""
        dev = next(iter(params.values())).device

        def mk(p):
            p32 = _as_f32(p.detach())
            slots = dict(self.init_slots(p32))
            if p.dtype in _LOW:
                slots["master"] = p32  # a copy: _as_f32 cast it up
            return slots

        state = {"step": torch.zeros((), dtype=torch.int32, device=dev)}
        if self._use_fused():
            names = self._fused_names(params)
            master = torch.cat([params[n].detach().reshape(-1).float()
                                for n in names]) if names else \
                torch.zeros((0,), dtype=torch.float32, device=dev)
            state["fused"] = dict(self.init_slots(master), master=master)
            state["slots"] = {n: {} if n in names else mk(p)
                              for n, p in params.items()}
        else:
            state["slots"] = {n: mk(p) for n, p in params.items()}
        return state

    @staticmethod
    def _fused_names(params) -> List[str]:
        """The parameters the flat state packs, in its order."""
        return sorted(n for n, p in params.items() if p.is_floating_point())

    @torch.no_grad()
    def apply_gradients(self, params: Dict[str, torch.Tensor],
                        grads: Dict[str, Optional[torch.Tensor]],
                        state: dict, ok: Optional[torch.Tensor] = None,
                        lr_override=None) -> None:
        """One update of every parameter with a gradient, in place. With
        ``ok`` given, everything keeps its old value where it is False,
        the step counter included. A parameter whose gradient is None (or
        missing) is skipped, moments and decay included: a direct caller
        gets that. ``static.TrainStep`` never passes None: it gives a
        parameter the loss does not reach a zero gradient, as JAX does, so
        AdamW decays it and its moments decay."""
        step = state["step"] + 1
        lr_t = lr_override if lr_override is not None \
            else resolve_lr(self.learning_rate, step)
        # the single upcast site: clip and decay see fp32 (a global norm
        # in fp16 overflows)
        grads = {n: _g32(g) for n, g in grads.items() if n in params}
        meta = self._param_meta
        regs = {n: meta.get(n, (True, None))[1] for n in params}
        if self.grad_clip is not None:
            sub = {n: g for n, g in grads.items()
                   if meta.get(n, (True, None))[0]}
            if sub:
                grads.update(self.grad_clip(sub))
        if "fused" in state:
            if any(r is not None for r in regs.values()):
                raise ValueError(
                    "per-parameter regularizers are not supported with "
                    "optimizer_fused_state; set fused_state=False")
            if getattr(self, "apply_decay_param_fun", None) is not None:
                raise ValueError(
                    "apply_decay_param_fun needs per-parameter updates; "
                    "set fused_state=False")
            self._apply_fused(params, grads, state, lr_t, step, ok)
        else:
            leaves, sparse = [], []
            for name, p in params.items():
                g = grads.get(name)
                if g is None:
                    continue
                slots = state["slots"][name]
                p32 = slots.get("master", p)
                own = {k: v for k, v in slots.items() if k != "master"}
                if isinstance(g, RowSlices):
                    sparse.append(_Leaf(name, p32, g, own))
                else:
                    leaves.append(_Leaf(name, p32, self._decay_grad(
                        g, p32, regs[name]), own))
            self._update(leaves, lr_t, step, ok)
            for leaf in sparse:
                self.update_sparse(leaf.p32, leaf.g, leaf.slots, lr_t,
                                   step, ok, leaf.name)
            for leaf in leaves + sparse:
                p = params[leaf.name]
                if leaf.p32 is not p:
                    # the master cast down (an unchanged master gives the
                    # old value back)
                    p.copy_(leaf.p32)
        # in place, as every slot: a captured step reads the counter
        # where it was
        state["step"].copy_(step if ok is None
                            else torch.where(ok, step, state["step"]))

    def _apply_fused(self, params, grads, state, lr_t, step, ok) -> None:
        fused = state["fused"]
        master = fused["master"]
        names = self._fused_names(params)
        parts, frozen, offsets, undecayed = [], [], [], []
        off = 0
        for n in names:
            k = params[n].numel()
            g = grads.get(n)
            if g is None:
                parts.append(torch.zeros(k, dtype=torch.float32,
                                         device=master.device))
                frozen.append((off, k))
            else:
                if isinstance(g, RowSlices):
                    g = to_dense(g)
                    undecayed.append((off, k))
                parts.append(g.reshape(-1).float())
            offsets.append(off)
            off += k
        if off != master.numel():
            raise ValueError(f"fused optimizer state holds "
                             f"{master.numel()} entries, the parameters "
                             f"{off}")
        gflat = torch.cat(parts) if parts else master.new_zeros((0,))
        if self.weight_decay:
            decayed = master
            if undecayed:
                mask = torch.ones_like(master)
                for o, k in undecayed:
                    mask[o:o + k] = 0.0
                decayed = master * mask
            gflat = self._decay_grad(gflat, decayed)
        # a leaf without a gradient is an exact no-op: AdamW's decay and
        # the moments' decay would move it, so its slices are put back
        kept = [(o, k, {s: t[o:o + k].clone() for s, t in fused.items()})
                for o, k in frozen]
        self._update([_Leaf(None, master, gflat,
                            {k: v for k, v in fused.items()
                             if k != "master"})], lr_t, step, ok)
        for o, k, old in kept:
            for s, t in old.items():
                fused[s][o:o + k].copy_(t)
        for n, o in zip(names, offsets):
            p = params[n]
            p.copy_(master[o:o + p.numel()].view(p.shape))

    def _update(self, leaves: List[_Leaf], lr_t, step, ok) -> None:
        raise NotImplementedError

    def update_sparse(self, p32: torch.Tensor, g: RowSlices,
                      slots: Dict[str, torch.Tensor], lr_t, step,
                      ok: Optional[torch.Tensor] = None,
                      name: Optional[str] = None) -> None:
        """One update of ``p32`` (and its ``slots``) by the sparse
        gradient ``g``, in place (the old values where ``ok`` is False).
        Here: ``g`` densified and the dense update run (correct, not
        bandwidth-optimal); SGD and lazy Adam touch its rows alone."""
        self._update([_Leaf(name, p32, to_dense(g), slots)], lr_t, step,
                     ok)


def _select(ok: Optional[torch.Tensor], new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """``new``, or ``old`` where the skip guard's ``ok`` is False."""
    return new if ok is None else torch.where(ok, new, old)


class SGD(Optimizer):
    """Plain SGD (``sgd_op``): ``p - lr g`` in fp32 on the master (or the
    fp32 parameter); a sparse gradient updates its rows alone."""

    _elementwise_update = True

    def _update(self, leaves, lr_t, step, ok) -> None:
        for leaf in leaves:
            p = leaf.p32
            p.copy_(_select(ok, p - lr_t * leaf.g.to(p.dtype), p))

    def update_sparse(self, p32, g, slots, lr_t, step, ok=None,
                      name=None) -> None:
        r = _touched(g)
        _write_rows(p32, r, p32[r.rows] - lr_t * r.values.to(p32.dtype),
                    ok)


class Momentum(Optimizer):
    """Momentum (``momentum_op``, ``use_nesterov``): a fp32 ``velocity``
    slot per parameter."""

    _elementwise_update = True

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 use_nesterov: bool = False, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def init_slots(self, p32):
        return {"velocity": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        mu = self.momentum
        for leaf in leaves:
            p, vel = leaf.p32, leaf.slots["velocity"]
            g = leaf.g.to(p.dtype)
            v = mu * vel + g
            new_p = p - lr_t * (g + mu * v) if self.use_nesterov \
                else p - lr_t * v
            p.copy_(_select(ok, new_p, p))
            vel.copy_(_select(ok, v, vel))


class Adam(Optimizer):
    """Paddle Adam (``adam_op.h``): see the module note."""

    _elementwise_update = True

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 lazy_mode: bool = False, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_mode = lazy_mode

    def init_slots(self, p32):
        dt = _moment_dtype(p32.dtype)
        return {"m": torch.zeros(p32.shape, dtype=dt, device=p32.device),
                "v": torch.zeros(p32.shape, dtype=dt, device=p32.device)}

    def _bias_correct_lr(self, lr_t, step):
        step_f = step.to(torch.float32)
        return lr_t * torch.sqrt(1.0 - torch.pow(self.beta2, step_f)) \
            / (1.0 - torch.pow(self.beta1, step_f))

    def _update(self, leaves, lr_t, step, ok) -> None:
        lr_c = self._bias_correct_lr(lr_t, step)
        fused_leaf = GLOBAL_FLAGS.get("fused_adam")
        fused_flat = GLOBAL_FLAGS.get("use_pallas_adam")
        # variant -> leaves: the kernel's "leaf" and "flat" routes, and
        # None, the unfused update (the leaf variant's plain version)
        routes = {"leaf": [], "flat": [], None: []}
        for leaf in leaves:
            p, m, v = leaf.p32, leaf.slots["m"], leaf.slots["v"]
            fp32 = [t.dtype == torch.float32 for t in (p, m, v)]
            if fused_leaf and all(fp32):
                route = "leaf"
            elif fused_flat and fp32[0] and fp32[1] \
                    and p.numel() >= _FLAT_MIN_NUMEL:
                route = "flat"
            else:
                route = None
            routes[route].append(leaf)
        for variant, sel in routes.items():
            if not sel:
                continue
            coeffs = [self._decay_coeff(leaf.name) for leaf in sel]
            wd = next((c for c in coeffs if c is not None), 0.0)
            # lr * wd: a float for a float lr (taken in double, as the
            # kernel's scalar), else an fp32 device tensor
            lr_wd = lr_t * wd
            args = ([leaf.p32 for leaf in sel], [leaf.g for leaf in sel],
                    [leaf.slots["m"] for leaf in sel],
                    [leaf.slots["v"] for leaf in sel],
                    [c is not None for c in coeffs], lr_c, self.beta1,
                    self.beta2, self.epsilon, lr_wd, ok)
            if variant is None:
                _adam.adam_multi_plain(*args)
            else:
                kernels.maybe_fused_adam(*args, variant)

    def update_sparse(self, p32, g, slots, lr_t, step, ok=None,
                      name=None) -> None:
        """``lazy_mode``: the touched rows alone take the update (ref:
        adam_op.h's sparse functor), as the unfused dense update computes
        them; the other rows and their moments stay as they were.
        Otherwise the dense update of the densified gradient."""
        if not self.lazy_mode:
            return super().update_sparse(p32, g, slots, lr_t, step, ok,
                                         name)
        r = _touched(g)
        m, v = slots["m"], slots["v"]
        p_new, m_new, v_new = _adam.adam_leaf_plain(
            p32[r.rows], r.values.to(p32.dtype), m[r.rows].float(),
            v[r.rows].float(), self._bias_correct_lr(lr_t, step),
            self.beta1, self.beta2, self.epsilon)
        for t, new in ((m, m_new), (v, v_new), (p32, p_new)):
            _write_rows(t, r, new, ok)

    def _decay_coeff(self, name: Optional[str]) -> Optional[float]:
        """The decoupled decay coefficient ``wd`` of parameter ``name``
        (None: the flat fused master), or None for no decay (always None
        for Adam)."""
        return None


class AdamW(Adam):
    """Adam with decoupled weight decay: ``p -= lr * wd * p_old`` after
    the Adam step, with the uncorrected ``lr``; parameters whose name
    ``apply_decay_param_fun`` maps to False are not decayed."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.01,
                 apply_decay_param_fun=None, **kw) -> None:
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self.decoupled_weight_decay = weight_decay
        self.apply_decay_param_fun = apply_decay_param_fun
        self.weight_decay = None  # decoupled, not L2

    def _decay_coeff(self, name):
        fn = self.apply_decay_param_fun
        if fn is not None and name is not None and not fn(name):
            return None
        return self.decoupled_weight_decay


def _l2(t: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum(t^2))``, as the JAX package forms a leaf's norm."""
    return torch.sqrt(torch.sum(t * t))


class LarsMomentum(Optimizer):
    """Layer-adaptive rate scaling (``lars_momentum_op``; You et al.
    2017): each leaf's rate is ``lr * coeff * |p| / (|g| + wd |p| +
    eps)`` (``lr`` itself where ``|p|`` is 0), and ``v = mu v +
    local_lr (g + wd p)``, ``p - v``. Per leaf (one norm each), so not on
    the flat fused state."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 lars_coeff: float = 0.001,
                 lars_weight_decay: float = 0.0005, epsilon: float = 1e-9,
                 **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.lars_weight_decay = lars_weight_decay
        self.epsilon = epsilon

    def init_slots(self, p32):
        return {"velocity": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        wd = self.lars_weight_decay
        for leaf in leaves:
            p, vel = leaf.p32, leaf.slots["velocity"]
            g = leaf.g.to(p.dtype)
            p_norm, g_norm = _l2(p), _l2(g)
            local_lr = lr_t * self.lars_coeff * p_norm / (
                g_norm + wd * p_norm + self.epsilon)
            local_lr = torch.where(p_norm > 0, local_lr, lr_t)
            v = self.momentum * vel + local_lr * (g + wd * p)
            p.copy_(_select(ok, p - v, p))
            vel.copy_(_select(ok, v, vel))


class Adamax(Optimizer):
    """``adamax_op``: ``m = b1 m + (1 - b1) g``, ``u = max(b2 u, |g|)``,
    ``p - lr / (1 - b1^t) m / (u + eps)``."""

    _elementwise_update = True

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, p32):
        return {"m": torch.zeros_like(p32), "u": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        lr_c = lr_t / (1.0 - torch.pow(self.beta1, step.to(torch.float32)))
        for leaf in leaves:
            p, m0, u0 = leaf.p32, leaf.slots["m"], leaf.slots["u"]
            g = leaf.g.to(p.dtype)
            m = self.beta1 * m0 + (1 - self.beta1) * g
            u = torch.maximum(self.beta2 * u0, torch.abs(g))
            p.copy_(_select(ok, p - lr_c * m / (u + self.epsilon), p))
            m0.copy_(_select(ok, m, m0))
            u0.copy_(_select(ok, u, u0))


class Adagrad(Optimizer):
    """``adagrad_op``: ``moment += g^2``, ``p - lr g / (sqrt(moment) +
    eps)``; the moment starts at ``initial_accumulator_value``."""

    _elementwise_update = True

    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 initial_accumulator_value: float = 0.0, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def init_slots(self, p32):
        return {"moment": torch.full_like(p32,
                                          self.initial_accumulator_value)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        for leaf in leaves:
            p, mo = leaf.p32, leaf.slots["moment"]
            g = leaf.g.to(p.dtype)
            moment = mo + g * g
            new_p = p - lr_t * g / (torch.sqrt(moment) + self.epsilon)
            p.copy_(_select(ok, new_p, p))
            mo.copy_(_select(ok, moment, mo))


class Adadelta(Optimizer):
    """``adadelta_op``: running averages of ``g^2`` and of the update's
    square, the update ``g sqrt(asu + eps) / sqrt(asg + eps)`` times
    ``lr`` (1.0 by default)."""

    _elementwise_update = True

    def __init__(self, learning_rate=1.0, rho: float = 0.95,
                 epsilon: float = 1e-6, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def init_slots(self, p32):
        return {"avg_sq_grad": torch.zeros_like(p32),
                "avg_sq_update": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        rho, eps = self.rho, self.epsilon
        for leaf in leaves:
            p = leaf.p32
            sg, su = leaf.slots["avg_sq_grad"], leaf.slots["avg_sq_update"]
            g = leaf.g.to(p.dtype)
            asg = rho * sg + (1 - rho) * (g * g)
            upd = g * torch.sqrt(su + eps) / torch.sqrt(asg + eps)
            asu = rho * su + (1 - rho) * (upd * upd)
            p.copy_(_select(ok, p - lr_t * upd, p))
            sg.copy_(_select(ok, asg, sg))
            su.copy_(_select(ok, asu, su))


class RMSProp(Optimizer):
    """``rmsprop_op``: ``ms = rho ms + (1 - rho) g^2``; ``mom = momentum
    mom + lr g / sqrt(ms + eps)`` (``centered``: ``sqrt(ms - mg^2 +
    eps)`` with ``mg`` the running mean of ``g``); ``p - mom``."""

    _elementwise_update = True

    def __init__(self, learning_rate=0.001, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon
        self.momentum_coef = momentum
        self.centered = centered

    def init_slots(self, p32):
        s = {"mean_square": torch.zeros_like(p32),
             "moment": torch.zeros_like(p32)}
        if self.centered:
            s["mean_grad"] = torch.zeros_like(p32)
        return s

    def _update(self, leaves, lr_t, step, ok) -> None:
        rho, eps = self.rho, self.epsilon
        for leaf in leaves:
            p, sl = leaf.p32, leaf.slots
            g = leaf.g.to(p.dtype)
            ms = rho * sl["mean_square"] + (1 - rho) * (g * g)
            new = {"mean_square": ms}
            if self.centered:
                mg = rho * sl["mean_grad"] + (1 - rho) * g
                denom = torch.sqrt(ms - mg * mg + eps)
                new["mean_grad"] = mg
            else:
                denom = torch.sqrt(ms + eps)
            new["moment"] = self.momentum_coef * sl["moment"] \
                + lr_t * g / denom
            p.copy_(_select(ok, p - new["moment"], p))
            for k, v in new.items():
                sl[k].copy_(_select(ok, v, sl[k]))


class Lamb(Optimizer):
    """``lamb_op`` (layer-adaptive Adam for large batches): the
    bias-corrected Adam direction plus ``lamb_weight_decay p`` is scaled
    by the trust ratio ``|p| / |r|`` (1 where either norm is 0).
    ``exclude_from_weight_decay_fn(name)`` True drops the decay for that
    parameter. Per leaf (two norms each)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-6, exclude_from_weight_decay_fn=None,
                 **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lamb_weight_decay = lamb_weight_decay
        self.exclude_fn = exclude_from_weight_decay_fn

    def init_slots(self, p32):
        return {"m": torch.zeros_like(p32), "v": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        b1, b2 = self.beta1, self.beta2
        step_f = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, step_f)
        bc2 = 1.0 - torch.pow(b2, step_f)
        for leaf in leaves:
            p, m0, v0 = leaf.p32, leaf.slots["m"], leaf.slots["v"]
            wd = self.lamb_weight_decay
            if self.exclude_fn is not None and leaf.name is not None \
                    and self.exclude_fn(leaf.name):
                wd = 0.0
            g = leaf.g.to(p.dtype)
            m = b1 * m0 + (1 - b1) * g
            v = b2 * v0 + (1 - b2) * (g * g)
            r = (m / bc1) / (torch.sqrt(v / bc2) + self.epsilon) + wd * p
            p_norm, r_norm = _l2(p), _l2(r)
            trust = torch.where((p_norm > 0) & (r_norm > 0),
                                p_norm / r_norm, 1.0)
            p.copy_(_select(ok, p - lr_t * trust * r, p))
            m0.copy_(_select(ok, m, m0))
            v0.copy_(_select(ok, v, v0))


class Ftrl(Optimizer):
    """``ftrl_op`` (follow the regularised leader, L1/L2): the
    ``squared`` and ``linear`` accumulators, the new parameter the
    closed-form proximal point, 0 where ``|linear| <= l1``; the old
    accumulator is floored at 1e-20 before its power."""

    def __init__(self, learning_rate=0.001, l1: float = 0.0,
                 l2: float = 0.0, lr_power: float = -0.5, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def init_slots(self, p32):
        return {"squared": torch.zeros_like(p32),
                "linear": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        pw = -self.lr_power
        for leaf in leaves:
            p, sq, li = leaf.p32, leaf.slots["squared"], leaf.slots["linear"]
            g = leaf.g.to(p.dtype)
            new_sq = sq + g * g
            sigma = (torch.pow(new_sq, pw)
                     - torch.pow(torch.clamp(sq, min=1e-20), pw)) / lr_t
            lin = li + g - sigma * p
            quad = torch.pow(new_sq, pw) / lr_t + 2 * self.l2
            pre = (self.l1 * torch.sign(lin) - lin) / quad
            new_p = torch.where(torch.abs(lin) > self.l1, pre, 0.0)
            p.copy_(_select(ok, new_p, p))
            sq.copy_(_select(ok, new_sq, sq))
            li.copy_(_select(ok, lin, li))


class Dpsgd(Optimizer):
    """``dpsgd_op`` (differentially private SGD): each leaf's gradient
    clipped to norm ``clip``, plus Gaussian noise of std ``sigma * clip /
    batch_size``; ``p - lr (g + noise)``. The noise is drawn from the
    generator bound by ``core.random.rng_scope`` (a ``TrainStep``'s own,
    advanced by every step and registered with its graph), else from the
    optimizer's own, seeded with ``seed``. Torch's Philox bits are not
    the JAX package's threefry ones: only ``sigma=0`` matches it
    exactly."""

    def __init__(self, learning_rate=0.001, clip: float = 10.0,
                 batch_size: float = 16.0, sigma: float = 1.0,
                 seed: int = 0, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.clip = clip
        self.batch_size = batch_size
        self.sigma = sigma
        self.seed = seed
        self._generators: Dict[torch.device, torch.Generator] = {}

    def _generator(self, device: torch.device) -> torch.Generator:
        gen = _random.bound_generator("dpsgd")
        if gen is not None:
            return gen
        if device not in self._generators:
            self._generators[device] = torch.Generator(
                device=device).manual_seed(int(self.seed))
        return self._generators[device]

    def _update(self, leaves, lr_t, step, ok) -> None:
        std = self.sigma * self.clip / self.batch_size
        for leaf in leaves:
            p = leaf.p32
            g = leaf.g.to(p.dtype)
            scale = torch.clamp(self.clip / torch.clamp(_l2(g), min=1e-12),
                                max=1.0)
            g = g * scale
            noise = std * torch.randn(g.shape, dtype=g.dtype,
                                      device=g.device,
                                      generator=self._generator(g.device))
            p.copy_(_select(ok, p - lr_t * (g + noise), p))


class DecayedAdagrad(Optimizer):
    """``decayed_adagrad_op``: ``moment = decay moment + (1 - decay)
    g^2``, ``p - lr g / (sqrt(moment) + eps)``."""

    def __init__(self, learning_rate=0.001, decay: float = 0.95,
                 epsilon: float = 1e-6, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def init_slots(self, p32):
        return {"moment": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        for leaf in leaves:
            p, mo = leaf.p32, leaf.slots["moment"]
            g = leaf.g.to(p.dtype)
            moment = self.decay * mo + (1 - self.decay) * (g * g)
            new_p = p - lr_t * g / (torch.sqrt(moment) + self.epsilon)
            p.copy_(_select(ok, new_p, p))
            mo.copy_(_select(ok, moment, mo))


def _proximal(prox: torch.Tensor, lr, l1: float, l2: float
              ) -> torch.Tensor:
    """The L1/L2 proximal projection of ``prox`` at rate ``lr``."""
    return torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1,
                                          min=0.0) / (1.0 + lr * l2)


class ProximalGD(Optimizer):
    """``proximal_gd_op``: an SGD step, then the L1/L2 proximal
    projection."""

    def __init__(self, learning_rate=0.001, l1: float = 0.0,
                 l2: float = 0.0, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.l1, self.l2 = l1, l2

    def _update(self, leaves, lr_t, step, ok) -> None:
        for leaf in leaves:
            p = leaf.p32
            prox = p - lr_t * leaf.g.to(p.dtype)
            p.copy_(_select(ok, _proximal(prox, lr_t, self.l1, self.l2), p))


class ProximalAdagrad(Optimizer):
    """``proximal_adagrad_op``: an Adagrad step at the rate ``lr /
    (sqrt(moment) + eps)``, then the proximal projection at that rate."""

    def __init__(self, learning_rate=0.001, l1: float = 0.0,
                 l2: float = 0.0, epsilon: float = 1e-10, **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.epsilon = l1, l2, epsilon

    def init_slots(self, p32):
        return {"moment": torch.zeros_like(p32)}

    def _update(self, leaves, lr_t, step, ok) -> None:
        for leaf in leaves:
            p, mo = leaf.p32, leaf.slots["moment"]
            g = leaf.g.to(p.dtype)
            moment = mo + g * g
            rate = lr_t / (torch.sqrt(moment) + self.epsilon)
            new_p = _proximal(p - rate * g, rate, self.l1, self.l2)
            p.copy_(_select(ok, new_p, p))
            mo.copy_(_select(ok, moment, mo))


# the fluid.optimizer spellings
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
AdagradOptimizer = Adagrad
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
LambOptimizer = Lamb
FtrlOptimizer = Ftrl
LarsMomentumOptimizer = LarsMomentum

from .extras import (ExponentialMovingAverage, GradientMerge,  # noqa: E402
                     Lookahead, ModelAverage)
