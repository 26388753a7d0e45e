"""``paddle.distributed`` counterpart: the collectives, fleet, the
parameter server and the launcher.

Counterpart of ``paddle_tpu.distributed``: the collectives and the
environment of ``parallel``, ``fleet`` (strategies, the strategy compiler
and the cross-trainer metrics), ``ps`` (parameter-server training over the
native service) and ``spawn`` from ``launch``.
"""

from ..parallel import (all_gather, all_reduce, barrier, broadcast,
                        get_rank, get_world_size, init_parallel_env,
                        new_group, reduce, scatter)
from ..parallel.env import ParallelEnv
from . import fleet
from . import ps
from .launch import spawn  # noqa: F401
