"""Fleet: distributed training orchestration.

Counterpart of ``paddle_tpu.distributed.fleet``: the reference's Fleet
(``fleet.init``, ``distributed_optimizer``, ``DistributedStrategy``) over
a strategy compiler whose strategies wrap the construction of the train
step (recompute, gradient merge, amp, ZeRO, tensor parallelism, and the
DGC and LocalSGD steps) instead of rewriting a program, and ``metrics``,
statistics aggregated across the trainers over the native control plane.
"""

from .base import (DistributedStrategy, Fleet, PaddleCloudRoleMaker,
                   UserDefinedRoleMaker, fleet, init, distributed_optimizer)
from .strategy_compiler import apply_strategy
from . import metrics  # noqa: F401
