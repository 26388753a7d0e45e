"""Distributed and parallel runtime (data, tensor, pipeline and context
parallelism).

Counterpart of ``paddle_tpu.parallel``: one process per rank and card,
``torch.distributed`` process groups for the mesh axes (``mesh``), the
collectives over them (``collective``), the sharded train step with ZeRO
and tensor parallelism (``spmd``), the data-parallel wrapper, the GPipe
schedule (``pipeline``), LocalSGD (``localsgd``), deep gradient
compression (``dgc``), and ring/Ulysses attention over the flash kernels
(``long_context``). The exports are the JAX package's.
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
from .localsgd import LocalSGDStep  # noqa: F401
from .dgc import DGCTrainStep, dgc_allreduce, topk_sparsify  # noqa: F401
from .long_context import ring_attention, ulysses_attention  # noqa: F401
