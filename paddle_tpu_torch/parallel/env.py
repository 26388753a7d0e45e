"""Multi-process environment bootstrap.

Counterpart of ``paddle_tpu.parallel.env``: :class:`ParallelEnv` reads the
PADDLE-style rank variables (``PADDLE_TRAINER_ID``/``RANK``,
``PADDLE_TRAINERS_NUM``/``WORLD_SIZE``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT``), and :func:`init_parallel_env` joins the job.
Where the JAX package starts ``jax.distributed``'s coordination service,
the port creates torch's default process group, one process per rank:

- the backend is NCCL when a card is present and Gloo on the CPU
  (``PT_DIST_BACKEND`` chooses another: four Gloo ranks can share one
  card, which NCCL refuses);
- at world size 1 the group is still created, over an in-memory
  ``HashStore`` (no network), so that the collectives of a one-card job
  are real NCCL calls;
- above 1 the ranks meet at a ``FileStore`` (``PT_STORE_PATH``, which
  ``distributed.launch`` sets for the ranks it starts), else at a ``TCPStore`` on ``coordinator_address`` (or the
  first trainer endpoint, or ``MASTER_ADDR:MASTER_PORT``).

Each rank with NCCL binds the card ``rank % device_count``.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "backend"]

# the rank processes' rendezvous timeout: a rank that never arrives fails
# its peers instead of hanging them
INIT_TIMEOUT_S = 300.0


class ParallelEnv:
    """Rank information from the environment (the reference's
    ``dygraph/parallel.py`` ``ParallelEnv``)."""

    def __init__(self) -> None:
        self.rank = int(os.environ.get(
            "PADDLE_TRAINER_ID", os.environ.get("RANK", "0")))
        self.world_size = int(os.environ.get(
            "PADDLE_TRAINERS_NUM", os.environ.get("WORLD_SIZE", "1")))
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self.trainer_endpoints = eps.split(",") if eps else []
        self.current_endpoint = os.environ.get(
            "PADDLE_CURRENT_ENDPOINT", "")

    @property
    def local_rank(self) -> int:
        return self.rank

    @property
    def nranks(self) -> int:
        return self.world_size


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The default group's backend ("nccl" or "gloo"), None when no group
    exists."""
    return dist.get_backend() if is_initialized() else None


def _store(rank: int, world: int, coordinator_address: Optional[str],
           env: ParallelEnv):
    if world == 1:
        return dist.HashStore()
    path = os.environ.get("PT_STORE_PATH", "")
    if path:
        return dist.FileStore(path, world)
    addr = coordinator_address
    if addr is None and env.trainer_endpoints:
        addr = env.trainer_endpoints[0]
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    if addr is None:
        raise ValueError(
            f"init_parallel_env: world size {world} needs a rendezvous: "
            f"PT_STORE_PATH (a FileStore) or "
            f"coordinator_address= / MASTER_ADDR (a TCPStore)")
    host, port = addr.rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, rank == 0,
                         timeout=timedelta(seconds=INIT_TIMEOUT_S))


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None) -> ParallelEnv:
    """Joins the job (``paddle.distributed.init_parallel_env``): creates
    the default process group once per process (see the module note) and
    returns the :class:`ParallelEnv`."""
    env = ParallelEnv()
    if is_initialized():
        return env
    world = num_processes if num_processes is not None else env.world_size
    rank = process_id if process_id is not None else env.rank
    be = os.environ.get("PT_DIST_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if be == "nccl":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        be, store=_store(rank, world, coordinator_address, env),
        rank=rank, world_size=world,
        timeout=timedelta(seconds=INIT_TIMEOUT_S), **kw)
    return env


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else ParallelEnv().rank


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() \
        else ParallelEnv().world_size
