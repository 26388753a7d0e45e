"""Optimizers: the ``Optimizer`` base, SGD / Momentum, and Adam / AdamW as
Paddle computes them.

Counterpart of ``paddle_tpu.optimizer`` (``Optimizer``, ``SGD``,
``Momentum``, ``Adam``, ``AdamW``). ``SGD`` is ``p - lr g``;
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
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from .. import kernels
from ..flags import GLOBAL_FLAGS
from ..kernels import fused_adam as _adam
from . import lr
from .lr import LRScheduler, resolve_lr

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "AdamOptimizer",
           "SGDOptimizer", "MomentumOptimizer", "LRScheduler", "lr"]

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
        grads = {n: None if g is None else _as_f32(g)
                 for n, g in grads.items() if n in params}
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
            leaves = []
            for name, p in params.items():
                g = grads.get(name)
                if g is None:
                    continue
                slots = state["slots"][name]
                p32 = slots.get("master", p)
                leaves.append(_Leaf(name, p32,
                                    self._decay_grad(g, p32, regs[name]),
                                    {k: v for k, v in slots.items()
                                     if k != "master"}))
            self._update(leaves, lr_t, step, ok)
            for leaf in leaves:
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
        parts, frozen, offsets = [], [], []
        off = 0
        for n in names:
            k = params[n].numel()
            g = grads.get(n)
            if g is None:
                parts.append(torch.zeros(k, dtype=torch.float32,
                                         device=master.device))
                frozen.append((off, k))
            else:
                parts.append(g.reshape(-1).float())
            offsets.append(off)
            off += k
        if off != master.numel():
            raise ValueError(f"fused optimizer state holds "
                             f"{master.numel()} entries, the parameters "
                             f"{off}")
        gflat = torch.cat(parts) if parts else master.new_zeros((0,))
        if self.weight_decay:
            gflat = self._decay_grad(gflat, master)
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


def _select(ok: Optional[torch.Tensor], new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """``new``, or ``old`` where the skip guard's ``ok`` is False."""
    return new if ok is None else torch.where(ok, new, old)


class SGD(Optimizer):
    """Plain SGD (``sgd_op``): ``p - lr g`` in fp32 on the master (or the
    fp32 parameter). Not ported: the row-sparse update (it comes with
    the sparse gradients)."""

    _elementwise_update = True

    def _update(self, leaves, lr_t, step, ok) -> None:
        for leaf in leaves:
            p = leaf.p32
            p.copy_(_select(ok, p - lr_t * leaf.g.to(p.dtype), p))


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
                 **kw) -> None:
        super().__init__(learning_rate, **kw)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

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


# the fluid.optimizer spellings
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdamOptimizer = Adam
