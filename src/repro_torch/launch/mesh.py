"""Device meshes over ``torch.distributed``: the sharded counting lanes'
meshes, the production topologies and the local training meshes.

The port of ``repro.launch.mesh``. The
reference runs one process over every device of a JAX ``Mesh``; the port is
SPMD: one process a rank (one rank a card under NCCL, as ``torchrun``
launches it), and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, which the caller initialises
first::

    torch.distributed.init_process_group("nccl")   # under torchrun
    mesh = make_mesh((world,), ("data",))          # every rank, same order

A rank's shard is its position in ``mesh.mesh.flatten()``, the counterpart
of the reference's ``mesh.devices.flat``.

The reference's production targets are meshes over the whole world:
``make_production_mesh()`` is (16, 16) ``("data", "model")`` over 256
ranks, ``make_production_mesh(multi_pod=True)`` (2, 16, 16) ``("pod",
"data", "model")`` over 512; ``make_local_mesh(mp)`` splits whatever world
there is as (world / mp, mp) ``("data", "model")`` (the training driver's
``--model-parallel``). ``"pod"`` composes with ``"data"`` for the
hierarchical gradient reduction (``data_axes``); ``"model"`` carries the
tensor- and expert-parallel collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.models.meshctx import batch_axes

__all__ = [
    "PRODUCTION_SHAPES",
    "ProcessGroupNotInitializedError",
    "data_axes",
    "make_local_mesh",
    "make_mesh",
    "make_production_mesh",
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


#: The reference's production meshes: (shape, axes) by ``multi_pod``.
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's production mesh over the whole world: (16, 16)
    ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")`` with
    ``multi_pod``.

    Raises:
      ProcessGroupNotInitializedError: no default process group.
      ValueError: the world is not 256 ranks (512 with ``multi_pod``).
    """
    require_process_group("make_production_mesh")
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    need, world = 1, dist.get_world_size()
    for s in shape:
        need *= s
    if world != need:
        raise ValueError(f"the production mesh {shape} {axes} needs {need} "
                         f"ranks; the process group has {world}")
    return make_mesh(shape, axes, device_type=device_type)


def make_local_mesh(model_parallel: int = 1, *,
                    device_type: Optional[str] = None):
    """Whatever world there is, split (world / ``model_parallel``,
    ``model_parallel``) ``("data", "model")``.

    Raises:
      ProcessGroupNotInitializedError: no default process group.
      ValueError: ``model_parallel`` is not a positive divisor of the world
        size.
    """
    require_process_group("make_local_mesh")
    world, mp = dist.get_world_size(), int(model_parallel)
    if mp < 1 or world % mp:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the world of {world} ranks")
    return make_mesh((world // mp, mp), ("data", "model"),
                     device_type=device_type)


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes that carry the batch (``meshctx.batch_axes``): ``("pod",
    "data")`` where ``"pod"`` exists, in mesh order."""
    return batch_axes(mesh_axes(mesh))


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
