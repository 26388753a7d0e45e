"""``fluid.executor`` submodule spelling (ref:
python/paddle/fluid/executor.py): the implementations live in
``paddle_tpu_torch.static``."""

from ..static import Executor, global_scope  # noqa: F401
from . import scope_guard  # noqa: F401
