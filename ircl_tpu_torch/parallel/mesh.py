"""The device mesh: a ``DeviceMesh`` over a ``torch.distributed`` group.

Counterpart of ``ircl_tpu/parallel/mesh.py``. The reference's mesh is a grid
of the devices one process sees; here each rank is one process on one
device, and ``make_mesh`` lays the ranks of the current process group out
under the reference's axis names:

- ``data``: batch-parallel training and query-parallel embedding;
- ``corpus``: shards the corpus rows, of the sparse index and of the dense
  embedding matrix, so scoring is local and only each shard's (k scores,
  k ids) cross the group for the merge.

The collectives of an axis run on ``mesh.get_group(axis)``. Ranks on CUDA
default to NCCL, ranks on the CPU to gloo; a caller may name the backend
(``launch.py``), as ``chip_smoke.py`` does to put several gloo ranks on one
card.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ircl_tpu_torch.utils.device import resolve_device

DEFAULT_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def in_process_group() -> bool:
    """Whether this process is a rank: in a group already, or started by a
    launcher such as ``torchrun`` that described one in the environment."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def join_env_group(device_type: str, backend: Optional[str] = None) -> None:
    """Join the process group a launcher such as ``torchrun`` described in
    the environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), unless this process is in one already. Raises where
    there is neither."""
    if not in_process_group():
        raise RuntimeError(
            "no process group is initialized and the environment describes "
            "none: start the ranks with ircl_tpu_torch.parallel.launch or torchrun"
        )
    if dist.is_initialized():
        return
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend or DEFAULT_BACKENDS[device_type],
                            init_method="env://")


def make_mesh(
    axis_names: Sequence[str] = ("corpus",),
    shape: Optional[Sequence[int]] = None,
    device=None,
) -> DeviceMesh:
    """A mesh of every rank of the process group, on ``device``'s type (by
    default the card). ``shape`` defaults to all ranks on the first axis,
    as the reference's does to all devices. Where ``shape`` holds fewer
    ranks than the group, the group runs it as replicas: the ranks are cut
    into consecutive blocks of that many, each block a mesh of its own (the
    reference's mesh takes the first devices and leaves the others idle;
    here every rank takes part in one copy)."""
    device_type = resolve_device(device).type
    join_env_group(device_type)
    n = dist.get_world_size()
    names = tuple(axis_names)
    if shape is None:
        shape = (n,) + (1,) * (len(names) - 1)
    shape = tuple(shape)
    size = math.prod(shape)
    if size == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    if size > n or n % size:
        raise ValueError(f"a mesh of {shape} ranks does not tile the group's {n} ranks")
    full = init_device_mesh(device_type, (n // size,) + shape,
                            mesh_dim_names=("replica",) + names)
    return full[names if len(names) > 1 else names[0]]


def group_size(device=None) -> int:
    """The number of ranks of the process group, joined on ``device``'s
    type (by default the card) as ``make_mesh`` joins it."""
    join_env_group(resolve_device(device).type)
    return dist.get_world_size()


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh[axis].size()


def axis_groups(mesh, *axes):
    """The process groups of the named axes of ``mesh`` that span more than
    one rank (``None`` names are skipped). Explicit axes need the mesh."""
    axes = [a for a in axes if a is not None]
    if axes and mesh is None:
        raise ValueError(f"the explicit axes {axes} need mesh=: explicit SPMD has no "
                         "global arrays to carry the mesh")
    return tuple(mesh.get_group(a) for a in axes if axis_size(mesh, a) > 1)


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_mesh(mesh, axis: Optional[str] = None) -> None:
    """``TypeError`` unless ``mesh`` is a ``DeviceMesh``; ``ValueError``
    unless it has ``axis``, where one is named."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh, got {type(mesh).__name__}")
    if axis is not None and axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
