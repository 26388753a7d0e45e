"""Distributed and parallel runtime (data, tensor and context
parallelism).

Counterpart of ``paddle_tpu.parallel``: one process per rank and card,
``torch.distributed`` process groups for the mesh axes (``mesh``), the
collectives over them (``collective``), the sharded train step with ZeRO
(``spmd``), the data-parallel wrapper, and ring/Ulysses attention over the
flash kernels (``long_context``). Pipeline parallelism, LocalSGD and DGC
(``LocalSGDStep``, ``DGCTrainStep``, ``dgc_allreduce``, ``topk_sparsify``)
are not ported yet (ROADMAP A15 part 2).
"""

from . import collective, env, mesh, spmd
from .collective import (all_gather, all_reduce, all_to_all, barrier,
                         broadcast, get_group, new_group, ppermute,
                         reduce, reduce_scatter, scatter)
from .data_parallel import DataParallel
from .env import ParallelEnv, get_rank, get_world_size, init_parallel_env
from .mesh import (batch_sharding, create_mesh, create_multislice_mesh,
                   data_parallel_mesh, multislice_data_spec, named_sharding,
                   num_slices, replicated)
from .spmd import ShardedTrainStep, make_param_specs, megatron_param_rule
from .long_context import ring_attention, ulysses_attention  # noqa: F401
