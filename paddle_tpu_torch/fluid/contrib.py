"""``fluid.contrib`` routing (ref: python/paddle/fluid/contrib/): the
graduated capabilities live at their first-class homes."""

from __future__ import annotations

from .. import amp as mixed_precision  # noqa: F401  (contrib.mixed_precision)
from .. import slim  # noqa: F401  (contrib.slim quantization)
from ..utils import op_bench  # noqa: F401


def memory_usage(*a, **k):
    raise NotImplementedError(
        "contrib.memory_usage estimated ProgramDesc memory; here the "
        "caching allocator owns device memory: read "
        "torch.cuda.max_memory_allocated() or profile with "
        "paddle_tpu_torch.profiler instead")
