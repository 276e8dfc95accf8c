"""Device meshes over ``torch.distributed`` for the sharded counting lanes.

The port of ``repro.launch.mesh``'s ``make_mesh`` and ``mesh_axes``. The
reference runs one process over every device of a JAX ``Mesh``; the port is
SPMD: one process a rank (one rank a card under NCCL, as ``torchrun``
launches it), and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, which the caller initialises
first::

    torch.distributed.init_process_group("nccl")   # under torchrun
    mesh = make_mesh((world,), ("data",))          # every rank, same order

A rank's shard is its position in ``mesh.mesh.flatten()``, the counterpart
of the reference's ``mesh.devices.flat``. The production and pod meshes of
the reference have no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = [
    "ProcessGroupNotInitializedError",
    "make_mesh",
    "mesh_axes",
    "mesh_ranks",
    "mesh_shard_index",
    "require_process_group",
    "world_mesh",
]


class ProcessGroupNotInitializedError(RuntimeError):
    """A mesh was asked for before ``torch.distributed.init_process_group``."""


def require_process_group(what: str) -> None:
    """Raise ``ProcessGroupNotInitializedError`` unless the default process
    group is initialised; ``what`` names the caller in the message."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ProcessGroupNotInitializedError(
            f"{what} needs an initialised torch.distributed process group: "
            f"call torch.distributed.init_process_group first (torchrun "
            f"sets its address, rank and world size), one rank a card "
            f"under NCCL, or gloo on the CPU")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    already initialised default process group (``init_device_mesh``).

    Args:
      shape: the mesh shape; its product must be the world size.
      axes: one name a dimension.
      device_type: "cuda" (None) or "cpu", as the caller asks.

    Raises:
      ProcessGroupNotInitializedError: no default process group.
      ValueError: ``shape`` and ``axes`` differ in length, or the mesh's
        size is not the world size.
    """
    from torch.distributed.device_mesh import init_device_mesh

    require_process_group("make_mesh")
    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    size, world = 1, dist.get_world_size()
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"mesh shape {shape} holds {size} ranks; the "
                         f"process group has {world}")
    return init_device_mesh("cuda" if device_type is None else device_type,
                            shape, mesh_dim_names=axes)


def world_mesh(device_type: Optional[str] = None):
    """The 1-D ``("data",)`` mesh over every rank of the default process
    group: what a sharded lane takes when it is given no mesh, as the
    reference takes every visible device.

    Raises:
      ProcessGroupNotInitializedError: no default process group.
    """
    require_process_group("a sharded lane without a mesh")
    return make_mesh((dist.get_world_size(),), ("data",),
                     device_type=device_type)


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh's dimension names."""
    return tuple(mesh.mesh_dim_names)


def mesh_ranks(mesh) -> Tuple[int, ...]:
    """The mesh's ranks in shard order (``mesh.mesh.flatten()``)."""
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


def mesh_shard_index(mesh) -> int:
    """This rank's shard: its position in ``mesh_ranks(mesh)``.

    Raises:
      ValueError: this rank is not in the mesh.
    """
    rank = dist.get_rank()
    ranks = mesh_ranks(mesh)
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh's ranks {ranks}")
    return ranks.index(rank)
