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
can train on from the same point.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["tensor_from_numpy", "params_from_jax", "load_jax_params",
           "opt_state_from_jax"]


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
    """A JAX optimizer state (``{"step", "slots": {name: {"m", "v"[,
    "master"]}}[, "fused": {"m", "v", "master"}]}`` over a name-keyed
    ``param_dict()``) as the port's optimizer state for ``params`` (the
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
