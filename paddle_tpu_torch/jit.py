"""jit: serialized inference programs and traced layers.

Counterpart of ``paddle_tpu.jit``'s export half. The JAX package
serializes a layer's eval forward as a ``jax.export`` StableHLO module;
here the eval forward is a ``torch.export`` program:

- ``save(layer, path, input_spec)`` writes ``params/`` (checkpoint v3
  through ``io.save``: ``params/<dotted name>`` and ``buffers/<dotted
  name>``, which the JAX package's ``io.load`` reads too), ``module.pt2``
  (``torch.export.save`` of ``functional_call(layer, params, buffers,
  *args)`` in eval mode under ``torch.no_grad()``, the weights its
  inputs, so they live in ``params/`` alone) and ``meta.json`` (the input
  specs, the platform the program was traced on, and the format tag
  ``paddle_tpu_torch_export``, which the JAX loader refuses).
- ``load(path, device=None)`` / :class:`TranslatedLayer` runs such an
  artifact without the model's Python class. The kernels appear in the
  program as the ``paddle_tpu_torch::layer_norm`` / ``flash_attention``
  operators (``kernels.custom_ops``), defined when this module imports
  ``kernels``. A program traced on another platform than ``device``'s is
  moved there whole (``torch.export.passes.move_to_device_pass``), and
  one that still names another device after the move is refused.
- :class:`TracedLayer` freezes a layer's weights and exports its forward
  at the example inputs' shapes.

``InputSpec`` shapes may hold ``None``: every ``None`` becomes one
dynamic dimension (``torch.export.Dim``), as every ``None`` is the JAX
export's one symbol ``b``. The trace runs at size ``TRACE_SIZE`` there
(``torch.export`` specialises sizes 0 and 1), and the program takes any
size from 1 up. Flags are read while tracing, so the kernel routes they
choose are baked into the program, as ``jax.jit`` bakes them in.

Not ported: ``to_static``/``StaticFunction``/``not_to_static`` (they wait
for ``dy2static``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import io as io_mod
from . import kernels  # noqa: F401 -- defines the operators a program calls
from .core.dtype import convert_dtype
from .core.place import resolve_device

__all__ = ["InputSpec", "save", "load", "TranslatedLayer", "TracedLayer",
           "FORMAT", "TRACE_SIZE"]

FORMAT = "paddle_tpu_torch_export"
# the JAX package's tag, refused here by name
JAX_FORMAT = "paddle_tpu_jit"
# the size a dynamic dimension is traced at
TRACE_SIZE = 2


class InputSpec:
    """Declarative input signature (ref: static/input.py InputSpec).
    ``None`` dims are dynamic: the exported program takes any size
    there."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def example(self, device: torch.device) -> torch.Tensor:
        """Zeros of the spec's dtype, ``TRACE_SIZE`` at every None."""
        shape = [TRACE_SIZE if s is None else int(s) for s in self.shape]
        return torch.zeros(shape, dtype=convert_dtype(self.dtype),
                           device=device)

    def dynamic_shape(self, dim) -> Optional[Dict[int, Any]]:
        """``torch.export``'s dynamic-shape entry: ``dim`` at every
        None, or None for a static spec."""
        dyn = {i: dim for i, s in enumerate(self.shape) if s is None}
        return dyn or None

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


class _Functional(nn.Module):
    """``layer``'s forward as a function of its weights: ``forward(params,
    buffers, *args)``. The layer is held outside the module tree, so the
    program's only tensors are its inputs."""

    def __init__(self, layer: nn.Module) -> None:
        super().__init__()
        object.__setattr__(self, "layer", layer)

    def forward(self, params, buffers, *args):
        return torch.func.functional_call(self.layer, (params, buffers),
                                          args)


def _weights(layer: nn.Module) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, torch.Tensor]]:
    return ({k: p.detach() for k, p in layer.named_parameters()},
            {k: b.detach() for k, b in layer.named_buffers()})


def _device_of(layer: nn.Module) -> torch.device:
    first = next(iter(list(layer.parameters()) + list(layer.buffers())),
                 None)
    return torch.device("cpu") if first is None else first.device


def _export(layer: nn.Module, params: dict, buffers: dict,
            specs: Sequence[InputSpec]):
    """``torch.export`` of the layer's eval forward over ``(params,
    buffers, *args)``, with one dynamic dim for every None of the
    specs; the layer's training mode restored after."""
    dev = _device_of(layer)
    dim = torch.export.Dim("b", min=1)
    args = tuple(s.example(dev) for s in specs)
    dynamic = ({k: None for k in params}, {k: None for k in buffers},
               tuple(s.dynamic_shape(dim) for s in specs))
    was_training = layer.training
    layer.eval()
    try:
        with torch.no_grad():
            return torch.export.export(_Functional(layer),
                                       (params, buffers) + args,
                                       dynamic_shapes=dynamic)
    finally:
        if was_training:
            layer.train()


def save(layer, path: str, input_spec: Optional[Sequence] = None) -> None:
    """Serialize a layer's eval forward for serving (ref: jit.py save;
    io.py save_inference_model:52). Writes ``params/``, ``module.pt2``
    and ``meta.json`` under ``path`` (see the module note)."""
    if isinstance(layer, TracedLayer):
        layer = layer._layer
    if not isinstance(layer, nn.Module):
        raise ValueError("jit.save needs a Layer (a torch.nn.Module)")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (shapes may use "
                         "None for a polymorphic batch dim)")
    specs = [s if isinstance(s, InputSpec) else InputSpec(*s)
             for s in input_spec]
    params, buffers = _weights(layer)
    exported = _export(layer, params, buffers, specs)
    os.makedirs(path, exist_ok=True)
    io_mod.save({"params": params, "buffers": buffers},
                os.path.join(path, "params"))
    torch.export.save(exported, os.path.join(path, "module.pt2"))
    meta = {
        "format": FORMAT, "version": 1,
        "platforms": [_device_of(layer).type],
        "torch": torch.__version__,
        "input_spec": [{"shape": [None if s is None else int(s)
                                  for s in sp.shape],
                        "dtype": _dtype_name(sp.dtype),
                        "name": sp.name or f"x{i}"}
                       for i, sp in enumerate(specs)],
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _dtype_name(dtype) -> str:
    """A dtype spec's name (``"int64"``), as ``convert_dtype`` reads it
    back."""
    return str(convert_dtype(dtype)).replace("torch.", "")


def read_meta(path: str) -> dict:
    """An artifact's ``meta.json``; a JAX package artifact, or anything
    else without this package's format tag, raises ValueError naming its
    format."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{path} is not a paddle_tpu_torch export "
                         f"artifact (no readable meta.json: {e})") from e
    fmt = meta.get("format")
    if fmt == JAX_FORMAT:
        raise ValueError(
            f"{path} is a JAX package artifact (format {fmt!r}, a "
            f"jax.export StableHLO module), not a paddle_tpu_torch export "
            f"(format {FORMAT!r}): export the model with "
            f"paddle_tpu_torch.jit.save, or read its weights with "
            f"io.load_inference_model(path, model=...)")
    if fmt != FORMAT:
        raise ValueError(f"{path} is not a paddle_tpu_torch export "
                         f"artifact (format {fmt!r}, expected {FORMAT!r})")
    return meta


def _foreign_devices(gm: torch.fx.GraphModule,
                     device: torch.device) -> list:
    """The devices of another type than ``device``'s that the program's
    nodes name (a constant's device baked in at trace time)."""
    seen = set()
    for node in gm.graph.nodes:
        for v in list(node.args) + list(node.kwargs.values()):
            if isinstance(v, torch.device) and v.type != device.type:
                seen.add(str(v))
    return sorted(seen)


def _on_device(exported, platform: str, device: torch.device):
    """The program as a module running wholly on ``device``: as it is
    when it was traced there, else moved by ``move_to_device_pass``.
    Raises, naming the platform, when it cannot be moved or still names
    another device after the move."""
    if platform != device.type:
        try:
            from torch.export.passes import move_to_device_pass as move
        except ImportError:
            move = None
        if move is None:
            raise ValueError(
                f"the program was exported on {platform!r} and this torch "
                f"({torch.__version__}) cannot move it to {device}: export "
                f"it on {device.type!r}")
        exported = move(exported, device)
    module = exported.module()
    foreign = _foreign_devices(module, device)
    if foreign:
        raise ValueError(f"the program exported on {platform!r} still "
                         f"names {foreign} after its move to {device}")
    return module


class TranslatedLayer:
    """A loaded serving program (ref: jit.py TranslatedLayer): the
    exported forward with the stored weights, on ``device`` (None: the
    card), no Python model class required."""

    def __init__(self, path: str, device=None) -> None:
        self.meta = read_meta(path)
        self.device = resolve_device(device)
        self.platform = self.meta["platforms"][0]
        self._module = _on_device(
            torch.export.load(os.path.join(path, "module.pt2")),
            self.platform, self.device)
        flat = io_mod.load(os.path.join(path, "params"))
        # io.load flattens to "/"-joined keys; the names after the first
        # segment are the dotted layer paths
        self._params = {k.split("/", 1)[1]: v.to(self.device)
                        for k, v in flat.items() if k.startswith("params/")}
        self._buffers = {k.split("/", 1)[1]: v.to(self.device)
                         for k, v in flat.items()
                         if k.startswith("buffers/")}

    def __call__(self, *args):
        args = tuple(_as_tensor(a, self.device) for a in args)
        with torch.no_grad():
            return self._module(self._params, self._buffers, *args)

    @property
    def input_spec(self):
        return [InputSpec(tuple(s["shape"]), s["dtype"], s.get("name"))
                for s in self.meta["input_spec"]]


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def load(path: str, device=None) -> TranslatedLayer:
    """(ref: jit.py load). ``device`` None means the card."""
    return TranslatedLayer(path, device)


class TracedLayer:
    """Frozen (weights, exported forward) capture of a layer at its
    example inputs' shapes (ref: jit.py TracedLayer.trace /
    save_inference_model). The weights are copies taken at the trace."""

    def __init__(self, layer: nn.Module, example_args: Tuple) -> None:
        self._layer = layer
        self._example_args = example_args
        params, buffers = _weights(layer)
        self._params = {k: v.clone() for k, v in params.items()}
        self._buffers = {k: v.clone() for k, v in buffers.items()}
        specs = [InputSpec(tuple(x.shape), x.dtype) for x in example_args]
        self._module = _export(layer, self._params, self._buffers,
                               specs).module()

    @staticmethod
    def trace(layer: nn.Module, inputs: Sequence) -> Tuple[Any,
                                                          "TracedLayer"]:
        dev = _device_of(layer)
        inputs = tuple(_as_tensor(x, dev) for x in inputs)
        traced = TracedLayer(layer, inputs)
        return traced(*inputs), traced

    def __call__(self, *args):
        with torch.no_grad():
            return self._module(self._params, self._buffers, *args)

    def save_inference_model(self, dirname: str) -> None:
        save(self._layer, dirname,
             input_spec=[InputSpec(tuple(x.shape), x.dtype)
                         for x in self._example_args])
