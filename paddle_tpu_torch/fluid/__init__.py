"""``paddle.fluid`` migration namespace.

A reference user's ``import paddle.fluid as fluid`` becomes ``import
paddle_tpu_torch.fluid as fluid`` and the fluid spellings resolve, as in
``paddle_tpu.fluid`` (ref surface: python/paddle/fluid/__init__.py:35-78
— framework, executor, io, layers, dygraph, nets, optimizer,
regularizer, metrics, initializer, clip, profiler, ParamAttr, places,
data).

Graph-construction APIs with no counterpart here
(``default_startup_program``/``program_guard``) raise with the working
equivalent named, as ``layers.DynamicRNN`` does; everything else routes
to working code. ``scope_guard`` swaps the process-global
``static.Scope`` for its block, and an ``Executor`` reads the global
scope at each call, so executors made before the guard are covered.
"""

from __future__ import annotations

import contextlib

from .. import clip  # noqa: F401
from .. import io  # noqa: F401
from .. import layers  # noqa: F401
from .. import nets  # noqa: F401
from .. import optimizer  # noqa: F401
from .. import profiler  # noqa: F401
from .. import reader  # noqa: F401
from .. import regularizer  # noqa: F401
from .. import metric as metrics  # noqa: F401
from ..autograd import grad as _grad  # noqa: F401
from ..core.lod import (RaggedBatch, create_lod_tensor,  # noqa: F401
                        create_random_int_lodtensor)
from ..core.place import CPUPlace, CUDAPlace  # noqa: F401
from ..flags import get_flags, set_flags  # noqa: F401
from ..nn import initializer  # noqa: F401
from ..param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from ..static import (Executor, Program, Scope, data,  # noqa: F401
                      default_main_program, global_scope)
from ..static import program as _program
from ..tensor import Tensor  # noqa: F401

#: pinned host staging is ``core.arena``'s, not a user-facing place
CUDAPinnedPlace = CPUPlace


def is_compiled_with_cuda() -> bool:
    """One answer for both spellings (``fluid.is_compiled_with_cuda`` and
    ``fluid.framework.is_compiled_with_cuda``): whether a card is
    present, so the ported ``CUDAPlace(0) if is_compiled_with_cuda() else
    CPUPlace()`` picks the card where there is one."""
    from ..core.place import accelerator_available
    return accelerator_available()


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """(ref: executor.py scope_guard) runs Executor calls against
    ``scope``: the process-global scope is swapped for the block."""
    old = _program._global_scope
    _program._global_scope = scope
    try:
        yield
    finally:
        _program._global_scope = old


from . import dygraph  # noqa: E402,F401

# real submodules, so `from paddle_tpu_torch.fluid.executor import
# Executor` style imports port unchanged (ref: fluid/__init__.py:35-78)
from . import average  # noqa: E402,F401
from . import backward  # noqa: E402,F401
from . import contrib  # noqa: E402,F401
from . import core  # noqa: E402,F401
from . import executor  # noqa: E402,F401
from . import framework  # noqa: E402,F401
from . import incubate  # noqa: E402,F401
from . import transpiler  # noqa: E402,F401
from . import unique_name  # noqa: E402,F401
from .framework import Variable, in_dygraph_mode  # noqa: E402,F401
from .transpiler import (DistributeTranspiler,  # noqa: E402,F401
                         DistributeTranspilerConfig)

# fluid.input re-exports (ref: fluid/input.py)
embedding = layers.embedding
one_hot = layers.one_hot


def default_startup_program():
    raise NotImplementedError(
        "parameter initialization is eager here: layers initialize on "
        "construction (pass seed=/generator= for determinism); there is "
        "no startup program to run")


@contextlib.contextmanager
def program_guard(main_program=None, startup_program=None):
    raise NotImplementedError(
        "programs are not recorded op by op here: wrap the computation "
        "in a function and build paddle_tpu_torch.static.Program(fn) "
        "instead of recording ops under program_guard")


class DataFeeder:
    """(ref: data_feeder.py DataFeeder) turns a minibatch of sample
    tuples into the feed dict ``Executor.run`` takes (numpy arrays; the
    executor moves them to its place)."""

    def __init__(self, feed_list, place=None, program=None) -> None:
        import numpy as _np

        self._np = _np
        self.names = [f if isinstance(f, str) else getattr(f, "name", None)
                      or str(f) for f in feed_list]
        self.place = place

    def feed(self, iterable):
        cols = list(zip(*iterable))
        if len(cols) != len(self.names):
            raise ValueError(
                f"DataFeeder: batch rows have {len(cols)} fields for "
                f"{len(self.names)} feed names {self.names}")
        out = {}
        for n, col in zip(self.names, cols):
            arrs = [self._np.asarray(v) for v in col]
            if len({a.shape for a in arrs}) > 1:
                raise ValueError(
                    f"DataFeeder: field {n!r} has ragged sample shapes "
                    f"{sorted({a.shape for a in arrs})}. LoD-style "
                    "variable-length feeding is a dense redesign here: "
                    "pad to a fixed seq_len and pass lengths as their "
                    "own field (see paddle_tpu_torch.ops.sequence — every "
                    "op takes (x, length))")
            out[n] = self._np.stack(arrs)
        return out
