"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

It mirrors the JAX package's module paths (``models.gpt_lm``,
``serving_llm.engine``, ``kernels`` ...) and imports neither JAX nor
anything of ``paddle_tpu``. Every kernel the JAX package wrote in Pallas
for the TPU is, once ported, a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use. Entry points run on the
GPU unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel's plain PyTorch version runs instead.

Ported so far: GPT serving (``serving_llm.LLMEngine``, in process and
over the wire), BERT pretraining (``static.TrainStep``, ``io``,
``data``), the export and ``inference.Predictor``, observability, the
lint (``analysis``), the user entry point ``hapi.Model`` with
``metric``, the losses and ``verify``, the rest of the core
(``nn.Layer``, ``param_attr``, ``core.place``/``lod``) with the
transformer family, ``TransformerSeq2Seq`` with beam search
(``ops.beam``) and the file-driven ``data.dataset``, ResNet, the
parallel and distributed stack, and the static programming model
(``jit.to_static`` over ``dy2static``, ``static.Scope``/``Program``/
``Executor``) with the core op library at the root (``ops``),
``to_tensor``, the autograd transforms, the dtypes, ``seed`` and the
places, as the JAX package's root has them. One name differs:
``paddle_tpu_torch.clip`` is the gradient-clipping module (the clip op
is ``ops.clip``), where the JAX root's ``clip`` is the op.

The root reaches the subpackages the JAX root imports (``nn``, ``io``,
``static``, ``fluid``, ``slim``, ``sysconfig`` ...), ``ParamAttr``,
``WeightNormParamAttr``, ``batch``, ``get_default_dtype``/
``set_default_dtype`` and ``__version__``. The subpackages load at
their first use (a module ``__getattr__``), so ``import
paddle_tpu_torch`` stays as quick as it was and imports in any order.
"""

import importlib as _importlib

import torch as _torch

from . import errors, flags
from .flags import get_flags, set_flags
from .core import (CPUPlace, CUDAPlace, Place, device_count, get_device,
                   is_compiled_with_cuda, set_device)
from .core.dtype import convert_dtype, get_default_dtype, set_default_dtype
from .core.random import seed

# the dtypes under the JAX root's names
bfloat16 = _torch.bfloat16
bool_ = _torch.bool
complex64 = _torch.complex64
complex128 = _torch.complex128
float16 = _torch.float16
float32 = _torch.float32
float64 = _torch.float64
int8 = _torch.int8
int16 = _torch.int16
int32 = _torch.int32
int64 = _torch.int64
uint8 = _torch.uint8

# the functional op surface at the root (paddle.add, paddle.matmul, ...)
from .ops import *  # noqa: F401,F403,E402
from . import ops  # noqa: E402
from .tensor import Tensor, to_tensor  # noqa: E402
from .autograd import grad, no_grad, value_and_grad  # noqa: E402

# the gradient-clipping module keeps its name (see the module note)
clip = _importlib.import_module(".clip", __name__)
from . import version  # noqa: E402
from .version import __version__  # noqa: E402

# name -> (module, attribute or None for the module itself), loaded at
# first use; fluid comes last in the JAX root's import order
_LAZY = {name: (name, None) for name in (
    "amp", "data", "datasets", "distribution", "hapi", "inference", "io",
    "jit", "layers", "metric", "models", "native", "nets", "nn",
    "observability", "optimizer", "param_attr", "preemption", "profiler",
    "reader", "regularizer", "testing", "utils", "vision", "parallel",
    "static", "distributed", "incubate", "slim", "sysconfig", "fluid")}
_LAZY.update(fleet=("distributed.fleet", None),
             ParamAttr=("param_attr", "ParamAttr"),
             WeightNormParamAttr=("param_attr", "WeightNormParamAttr"),
             batch=("reader", "batch"))


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module 'paddle_tpu_torch' has no attribute {name!r}")
    module, attr = _LAZY[name]
    value = _importlib.import_module(f".{module}", __name__)
    if attr is not None:
        value = getattr(value, attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))

__all__ = (["get_flags", "set_flags", "errors", "flags", "CPUPlace",
            "CUDAPlace", "Place", "device_count", "get_device",
            "is_compiled_with_cuda", "set_device", "convert_dtype",
           "get_default_dtype", "set_default_dtype", "__version__", "seed",
            "bfloat16", "bool_", "complex64", "complex128", "float16",
            "float32", "float64", "int8", "int16", "int32", "int64",
            "uint8", "ops", "Tensor", "to_tensor", "grad", "no_grad",
            "value_and_grad"]
           + [n for n in ops.__all__ if n != "clip"])
