"""Move weights and optimizer state from the JAX package into the PyTorch
package.

``params_from_jax`` takes a JAX layer's ``param_dict()`` as numpy arrays,
keyed by dotted parameter name (``blocks.3.qkv.weight``), and returns a
state dict of tensors in the arrays' own dtypes: fp32, fp16, and bf16
(numpy holds bf16 as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses; its bits are viewed as ``uint16`` and then as
``torch.bfloat16``, so ``ml_dtypes`` is never imported here). The port
keeps the JAX layouts (Linear weights ``[in, out]``), so nothing is
transposed. ``load_jax_params`` loads such a dict into a module after
checking keys and shapes strictly. ``opt_state_from_jax`` carries an
``Optimizer.init``/``apply_gradients`` state across, so both packages
can train on from the same point, whatever the optimizer's slots
(Adam's moments, Momentum's velocity).

The whole training state crosses both ways: ``train_state_from_jax``
turns a JAX ``TrainStep.state`` (its leaves as numpy arrays, the ``rng``
key as its raw bits, ``jax.random.key_data``) into the tree the port's
``TrainStep.set_state_dict`` restores, and ``train_state_to_jax`` turns
the port's ``TrainStep.state_dict()`` into numpy leaves in the JAX
state's structure (bf16 as ``ml_dtypes.bfloat16``, which only a JAX
user needs and so is imported there alone), without the port's
generator: the JAX step keeps its own ``rng``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["tensor_from_numpy", "params_from_jax", "load_jax_params",
           "opt_state_from_jax", "train_state_from_jax",
           "train_state_to_jax"]


def tensor_from_numpy(value: object) -> torch.Tensor:
    """A numpy (or array-like) value as a CPU tensor of its own dtype,
    bf16 included; the tensor owns a copy."""
    a = np.array(value, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """numpy (or array-like) parameters by dotted name -> CPU tensors."""
    return {name: tensor_from_numpy(value) for name, value in params.items()}


def load_jax_params(module: torch.nn.Module,
                    params: Mapping[str, object]) -> torch.nn.Module:
    """Copy ``params`` (a JAX ``param_dict()`` as numpy arrays, or the
    output of :func:`params_from_jax`) into ``module`` in place. Raises
    ValueError naming every missing or unexpected key and every shape
    mismatch; dtypes follow the module's parameters."""
    state = {k: (v if isinstance(v, torch.Tensor) else tensor_from_numpy(v))
             for k, v in params.items()}
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    shapes = [f"{k}: {tuple(state[k].shape)} != {tuple(own[k].shape)}"
              for k in sorted(set(own) & set(state))
              if tuple(state[k].shape) != tuple(own[k].shape)]
    if missing or unexpected or shapes:
        raise ValueError(f"parameter mismatch: missing={missing} "
                         f"unexpected={unexpected} shapes={shapes}")
    with torch.no_grad():
        for name, value in own.items():
            value.copy_(state[name].to(value.dtype))
    return module


def opt_state_from_jax(state: Mapping[str, object],
                       params: Mapping[str, torch.Tensor]) -> dict:
    """A JAX optimizer state (``{"step", "slots": {name: {slot: ...}}[,
    "fused": {slot: ...}]}`` over a name-keyed ``param_dict()``: Adam's
    ``m``/``v``, Momentum's ``velocity``, SGD's none, plus ``master``
    for a low-precision parameter) as the port's optimizer state for
    ``params`` (the
    port's name-keyed parameters), every tensor on their device in the
    dtype JAX stored it in. The JAX package packs the flat fused vectors
    in its leaf order, sorted by name, and so does the port. Raises
    ValueError when the names or shapes differ from ``params``."""
    names = set(params)
    slots_in = state["slots"]
    if set(slots_in) != names:
        raise ValueError(f"optimizer state names differ from the "
                         f"parameters: {sorted(set(slots_in) ^ names)}")
    dev = next(iter(params.values())).device

    def move(value, shape=None):
        t = tensor_from_numpy(np.asarray(value)).to(dev)
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"optimizer state shape {tuple(t.shape)} != "
                             f"parameter shape {tuple(shape)}")
        return t

    out = {"step": move(state["step"]).to(torch.int32).reshape(()),
           "slots": {n: {k: move(v, params[n].shape)
                         for k, v in slots_in[n].items()}
                     for n in params}}
    if "fused" in state:
        out["fused"] = {k: move(v) for k, v in state["fused"].items()}
        total = sum(p.numel() for n, p in params.items()
                    if not out["slots"][n] and p.is_floating_point())
        for k, t in out["fused"].items():
            if t.shape != (total,):
                raise ValueError(f"fused {k} has {tuple(t.shape)} entries, "
                                 f"the parameters {total}")
    return out


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def train_state_from_jax(state: Mapping[str, object]) -> dict:
    """A JAX ``TrainStep.state`` (``{"params", "buffers", "opt", "rng"[,
    "scaler"]}``, numpy or array-like leaves, ``rng`` as its raw key
    bits) as a tree of CPU tensors in the dtypes JAX stored, for the
    port's ``TrainStep.set_state_dict`` (which seeds its generator from
    ``rng``)."""
    return _map_tree(tensor_from_numpy, dict(state))


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # a JAX user's dependency, needed by it alone
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def train_state_to_jax(state: Mapping[str, object]) -> dict:
    """The port's ``TrainStep.state_dict()`` as numpy leaves in the JAX
    ``TrainStep.state``'s structure, without ``generator`` (the JAX step
    keeps its own ``rng``): ``jax_step.state.update(jax.tree.map(
    jnp.asarray, train_state_to_jax(port_step.state_dict())))``."""
    return _map_tree(_to_numpy, {k: v for k, v in state.items()
                                 if k != "generator"})
