"""``fluid.framework`` surface (ref: python/paddle/fluid/framework.py):
the names user code touches of the graph-description machinery."""

from __future__ import annotations

from ..core.place import CPUPlace, CUDAPlace  # noqa: F401
from ..nn import Parameter  # noqa: F401
from ..static import (Program, default_main_program,  # noqa: F401
                      global_scope)
from ..tensor import Tensor
from . import is_compiled_with_cuda  # noqa: F401

Variable = Tensor  # tensors fill the Variable role


def in_dygraph_mode() -> bool:
    """Eager is always on."""
    return True


def _non_static_mode() -> bool:
    return True
