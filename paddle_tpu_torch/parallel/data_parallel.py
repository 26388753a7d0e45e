"""DataParallel layer wrapper (dygraph parity).

Counterpart of ``paddle_tpu.parallel.data_parallel`` (the reference's
``fluid/dygraph/parallel.py`` ``DataParallel``). The wrapper is thin:
``ShardedTrainStep`` reduces gradients itself, so ``DataParallel`` carries
the mesh and the environment and gives code written against the reference
``scale_loss`` (the identity under a mean reduction) and
``apply_collective_grads`` (each gradient's mean over ``dp``, an all-reduce
per gradient; the identity outside a process group).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..nn.layer import Layer
from . import collective
from .env import ParallelEnv
from .mesh import Mesh, data_parallel_mesh

__all__ = ["DataParallel"]


class DataParallel(Layer):
    def __init__(self, layers: nn.Module, strategy=None,
                 mesh: Optional[Mesh] = None) -> None:
        super().__init__()
        self._layers = layers
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        self.env = ParallelEnv()
        self.nranks = self.mesh.size

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        """The identity: the gradients are averaged, not summed."""
        return loss

    def apply_collective_grads(self, grads: Dict[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
        """Every gradient's mean over the ``dp`` axis."""
        with self.mesh:
            return {n: collective.all_reduce(g, "mean", group="dp")
                    for n, g in grads.items()}

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)
