"""``paddle.distributed`` counterpart: the collectives and the launcher.

Counterpart of ``paddle_tpu.distributed``: the collectives and the
environment of ``parallel``, and ``spawn`` from ``launch``. ``fleet`` and
the parameter server (``ps``) are not ported yet (ROADMAP A15 part 2).
"""

from ..parallel import (all_gather, all_reduce, barrier, broadcast,
                        get_rank, get_world_size, init_parallel_env,
                        new_group, reduce, scatter)
from ..parallel.env import ParallelEnv
from .launch import spawn  # noqa: F401
