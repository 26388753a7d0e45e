"""Fleet base: ``DistributedStrategy`` with its configs, the role makers,
``Fleet`` and its module-level singleton.

Counterpart of ``paddle_tpu.distributed.fleet.base``, the same names,
defaults and behaviour (the reference's fleet_base.py ``Fleet`` and
distributed_strategy.proto toggles; the role makers read the
``PADDLE_*`` environment through ``parallel.ParallelEnv``). The strategy
is applied when a step is built (``strategy_compiler.apply_strategy``).
What a toggle means on this card is said there;
``cudnn_exhaustive_search`` and ``nccl_comm_num`` are kept for parity
and read by nothing, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ...parallel.env import ParallelEnv, init_parallel_env


@dataclass
class RecomputeConfig:
    checkpoints: list = field(default_factory=list)
    policy: str = "nothing_saveable"


@dataclass
class GradientMergeConfig:
    k_steps: int = 1
    avg: bool = True


@dataclass
class LocalSGDConfig:
    k_steps: int = 1


@dataclass
class AMPConfig:
    init_loss_scaling: float = 2.0 ** 15
    use_dynamic_loss_scaling: bool = True
    dtype: str = "bfloat16"


@dataclass
class PipelineConfig:
    micro_batch: int = 1
    stages: int = 1


@dataclass
class DGCConfig:
    # dense warm-up steps before compression kicks in (paper §3.3
    # warm-up training; DGCTrainStep's own default)
    rampup_begin_step: int = 3
    sparsity: float = 0.999


@dataclass
class ShardingConfig:
    """ZeRO-style optimizer state sharding over dp."""
    stage: int = 1


class DistributedStrategy:
    """(ref: distributed_strategy.proto:94 + python wrapper). Feature
    toggles consumed by the strategy compiler."""

    def __init__(self) -> None:
        self.amp = False
        self.amp_configs = AMPConfig()
        self.recompute = False
        self.recompute_configs = RecomputeConfig()
        self.gradient_merge = False
        self.gradient_merge_configs = GradientMergeConfig()
        self.localsgd = False
        self.localsgd_configs = LocalSGDConfig()
        self.pipeline = False
        self.pipeline_configs = PipelineConfig()
        self.dgc = False
        self.dgc_configs = DGCConfig()
        self.sharding = False
        self.sharding_configs = ShardingConfig()
        self.lamb = False
        self.lars = False
        self.nccl_comm_num = 1          # parity: multiple comm rings
        self.hierarchical_allreduce = False  # a (dcn, dp) batch split
        self.sync_batch_norm = False
        self.fuse_grad_size_in_MB = 32
        self.cudnn_exhaustive_search = False  # read by nothing
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()}


class RoleMakerBase:
    def __init__(self) -> None:
        self.env = ParallelEnv()

    def worker_index(self) -> int:
        return self.env.rank

    def worker_num(self) -> int:
        return self.env.world_size

    def is_first_worker(self) -> bool:
        return self.env.rank == 0

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False


class PaddleCloudRoleMaker(RoleMakerBase):
    """(ref: role_maker.py:481) — env-var driven."""

    def __init__(self, is_collective: bool = True) -> None:
        super().__init__()
        self.is_collective = is_collective


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id: int = 0, workers: int = 1,
                 **kw) -> None:
        super().__init__()
        self.env.rank = current_id
        self.env.world_size = workers


class Fleet:
    """(ref: fleet_base.py:42). Singleton via module-level ``fleet``."""

    def __init__(self) -> None:
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False

    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None) -> "Fleet":
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self._strategy = strategy or DistributedStrategy()
        if self._role_maker.worker_num() > 1:
            init_parallel_env()
        self._is_initialized = True
        return self

    @property
    def strategy(self) -> DistributedStrategy:
        return self._strategy or DistributedStrategy()

    def worker_index(self) -> int:
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_num(self) -> int:
        return self._role_maker.worker_num() if self._role_maker else 1

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0

    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy]
                              = None):
        """(ref: fleet_base.py distributed_optimizer → meta-opt pipeline).
        Returns the optimizer annotated with the strategy; the strategy is
        applied when a sharded step is built (strategy_compiler.py)."""
        if strategy is not None:
            self._strategy = strategy
        optimizer._fleet_strategy = self.strategy
        return optimizer

    def build_train_step(self, model, optimizer, loss_fn, mesh=None,
                         **kwargs):
        """Compile a distributed train step under the current strategy —
        the minimize() analogue for the functional design."""
        from .strategy_compiler import apply_strategy
        return apply_strategy(self.strategy, model, optimizer, loss_fn,
                              mesh=mesh, **kwargs)

    def barrier_worker(self) -> None:
        from ...parallel.collective import barrier
        barrier()

    def save_persistables(self, state, path: str) -> None:
        from ... import io
        if self.is_first_worker():
            io.save(state, path)

    def stop_worker(self) -> None:
        pass


fleet = Fleet()


def init(role_maker=None, is_collective: bool = True, strategy=None):
    return fleet.init(role_maker, is_collective, strategy)


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)
