"""Move weights from the JAX package into the PyTorch package.

``params_from_jax`` takes a JAX layer's ``param_dict()`` as numpy arrays,
keyed by dotted parameter name (``blocks.3.qkv.weight``), and returns a
state dict of float tensors. The port keeps the JAX layouts (Linear
weights ``[in, out]``), so nothing is transposed. ``load_jax_params``
loads such a dict into a module after checking keys and shapes strictly.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "load_jax_params"]


def params_from_jax(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """numpy (or array-like) parameters by dotted name -> CPU tensors."""
    return {name: torch.from_numpy(np.array(value, copy=True))
            for name, value in params.items()}


def load_jax_params(module: torch.nn.Module,
                    params: Mapping[str, object]) -> torch.nn.Module:
    """Copy ``params`` (a JAX ``param_dict()`` as numpy arrays, or the
    output of :func:`params_from_jax`) into ``module`` in place. Raises
    ValueError naming every missing or unexpected key and every shape
    mismatch; dtypes follow the module's parameters."""
    state = {k: (v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v, copy=True)))
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
