"""Device meshes over the ranks of a job.

Counterpart of ``paddle_tpu.parallel.mesh``, the same names and errors.
The JAX mesh is an array of devices one program drives; here every rank
is a process with one card, so a mesh is an array of RANKS with named
axes (``dp`` data, ``mp`` tensor, ``pp`` pipeline, ``sp`` sequence,
``ep`` expert), and each axis's communicator is a process group.

With a default process group (``parallel.init_parallel_env``) the mesh
holds a ``torch.distributed.device_mesh.DeviceMesh`` over those ranks
(``device_mesh``), whose per-axis groups the collectives run on; a group
over several axes at once (a multislice batch spec's ``("dcn", "dp")``)
is made the first time it is asked for, by every rank at the same
point of the program. Without a process group the world is this one
process: a mesh of size 1 whose collectives are the identity, the JAX
package's single-process meaning.

``with mesh:`` makes a mesh the one that axis names resolve against
(``collective``'s ``group="dp"``); otherwise the mesh created last.

The multislice functions build the two-level mesh over hosts and cards:
ranks are numbered host by host (``distributed.launch`` numbers them so),
``num_slices`` is the world over ``LOCAL_WORLD_SIZE`` (the ranks of one
host), and the outer (``dcn``) axes cross hosts.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from . import env as _env

__all__ = ["DP", "MP", "PP", "SP", "EP", "Mesh", "PartitionSpec", "P",
           "NamedSharding", "create_mesh", "num_slices",
           "create_multislice_mesh", "multislice_data_spec",
           "data_parallel_mesh", "mesh_axis_size", "named_sharding",
           "replicated", "batch_sharding", "current_mesh"]

DP, MP, PP, SP, EP = "dp", "mp", "pp", "sp", "ep"

AxisName = Union[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per dimension: a mesh axis name, a tuple of them, or
    None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class _Current(threading.local):
    def __init__(self) -> None:
        self.stack: list = []


_current = _Current()
_last: Optional["Mesh"] = None


def current_mesh() -> Optional["Mesh"]:
    """The mesh of the innermost ``with mesh:`` on this thread, else the
    mesh created last, else None."""
    return _current.stack[-1] if _current.stack else _last


class Mesh:
    """Ranks on named axes: ``shape`` maps each axis to its size (in
    order), ``devices`` is the rank array, ``coordinate`` this rank's
    place in it (None for a rank the mesh leaves idle)."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]) -> None:
        global _last
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        self.size = int(self.devices.size)
        me = _env.get_rank() if _env.is_initialized() else 0
        where = np.argwhere(self.devices == me)
        self.coordinate: Optional[Tuple[int, ...]] = \
            tuple(int(i) for i in where[0]) if len(where) else None
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        if _env.is_initialized():
            import torch
            from torch.distributed.device_mesh import DeviceMesh
            dev = "cuda" if _env.backend() == "nccl" else "cpu"
            self.device_mesh = DeviceMesh(
                dev, torch.as_tensor(self.devices.astype(np.int64)),
                mesh_dim_names=self.axis_names)
        _last = self

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def __enter__(self) -> "Mesh":
        _current.stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _current.stack.pop()

    def _axes(self, axis: AxisName) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh {self.shape} has no axis {a!r}")
        return axes

    def axis_size(self, axis: AxisName) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axis)]))

    def axis_index(self, axis: AxisName) -> int:
        """This rank's index along ``axis`` (several axes: row-major over
        them, as a JAX spec entry ``("dcn", "dp")`` orders them)."""
        if self.coordinate is None:
            raise RuntimeError(f"this rank is not in the mesh {self.shape}")
        idx = 0
        for a in self._axes(axis):
            d = self.axis_names.index(a)
            idx = idx * self.shape[a] + self.coordinate[d]
        return idx

    def group(self, axis: AxisName):
        """The process group of this rank's line along ``axis``; None
        without a default process group (the identity world)."""
        axes = self._axes(axis)
        if self.device_mesh is None:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            # every rank makes every line's group, in one order
            dims = [self.axis_names.index(a) for a in axes]
            rest = [d for d in range(self.devices.ndim) if d not in dims]
            lines = np.transpose(self.devices, rest + dims).reshape(
                -1, int(np.prod([self.devices.shape[d] for d in dims])))
            mine = None
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.coordinate is not None \
                        and _env.get_rank() in line:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec) -> None:
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _world() -> int:
    return _env.get_world_size() if _env.is_initialized() else 1


def create_mesh(axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence[int]] = None,
                allow_submesh: bool = False) -> Mesh:
    """A mesh from an axis -> size dict, e.g. ``{"dp": 4, "mp": 2}``, over
    the job's ranks (``devices``: a list of ranks, default all).

    Sizes of -1 (at most one) absorb the remaining ranks. Axis sizes that
    cover fewer ranks than available are an error unless
    ``allow_submesh=True`` (the mesh takes the first ``total`` ranks and
    leaves the rest idle)."""
    devices = list(devices) if devices is not None else list(range(_world()))
    axes = dict(axes) if axes else {DP: len(devices)}
    n = len(devices)
    known = 1
    wild = None
    for name, size in axes.items():
        if size == -1:
            wild = name
        else:
            known *= size
    if wild is not None:
        if known <= 0 or n % known != 0:
            raise ValueError(
                f"mesh axes {axes} with wildcard: {n} devices not "
                f"divisible by {known}")
        axes[wild] = n // known
    total = int(np.prod(list(axes.values())))
    if total > n or total <= 0:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    if total < n and not allow_submesh:
        raise ValueError(
            f"mesh axes {axes} cover {total} of {n} devices; use -1 to "
            f"absorb the rest or allow_submesh=True to idle them")
    arr = np.array(devices[:total]).reshape(tuple(axes.values()))
    return Mesh(arr, tuple(axes))


def num_slices(devices: Optional[Sequence[int]] = None) -> int:
    """Hosts among the job's ranks: the world over ``LOCAL_WORLD_SIZE``
    (1 when unset, as a single host or the CPU)."""
    n = len(devices) if devices is not None else _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n) or n)
    return max(1, n // max(1, local))


def create_multislice_mesh(dcn_axes: Dict[str, int],
                           ici_axes: Dict[str, int],
                           devices: Optional[Sequence[int]] = None) -> Mesh:
    """Two-level mesh: ``dcn_axes`` (outermost) cross hosts, ``ici_axes``
    stay within one host's cards. One ici axis may be -1 to absorb the
    remaining per-host ranks. Sharding a batch over ``P(("dcn", "dp"))``
    reduces over both levels."""
    devices = list(devices) if devices is not None else list(range(_world()))
    dcn_axes = dict(dcn_axes)
    ici_axes = dict(ici_axes)
    n = len(devices)
    n_dcn = int(np.prod(list(dcn_axes.values())))
    if n_dcn <= 0 or n % n_dcn != 0:
        raise ValueError(
            f"dcn axes {dcn_axes} do not divide {n} devices")
    per_slice = n // n_dcn
    wild = [k for k, v in ici_axes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError("at most one ici axis may be -1")
    if wild:
        known = int(np.prod([v for v in ici_axes.values() if v != -1]))
        if known <= 0 or per_slice % known != 0:
            raise ValueError(
                f"ici axes {ici_axes}: {per_slice} per-slice devices not "
                f"divisible by {known}")
        ici_axes[wild[0]] = per_slice // known
    if int(np.prod(list(ici_axes.values()))) != per_slice:
        raise ValueError(
            f"ici axes {ici_axes} must cover {per_slice} devices/slice")
    names = tuple(dcn_axes) + tuple(ici_axes)
    shape = tuple(dcn_axes.values()) + tuple(ici_axes.values())
    return Mesh(np.array(devices).reshape(shape), names)


def multislice_data_spec(mesh: Mesh, dcn_axis: str = "dcn",
                         dp_axis: str = DP) -> PartitionSpec:
    """Batch spec sharding over (dcn, dp) jointly: the hierarchical
    data-parallel layout."""
    axes = tuple(a for a in (dcn_axis, dp_axis) if a in mesh.shape)
    return PartitionSpec(axes if len(axes) > 1 else axes[0])


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    devs = list(range(_world()))
    devs = devs[:n] if n else devs
    return create_mesh({DP: len(devs)}, devs)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.shape else 1


def named_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def batch_sharding(mesh: Mesh, axis: str = DP) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis."""
    return NamedSharding(mesh, PartitionSpec(axis))
