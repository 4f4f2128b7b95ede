"""Mesh descriptions (port of the part of ``repro.launch.mesh`` that has a
torch meaning).

The reference builds XLA device meshes (TPU v5e pods, ``MESH_SHAPES``).
The port runs one process per rank under ``torch.distributed`` with data
parallelism only, so a mesh here is a description: axis names, their
sizes, and the process group the data axes reduce over. The sharding
rules (``launch.sharding``) read ``axis_names`` and ``shape`` only, as
the reference's do, so they take this class or any object with those
two attributes.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

__all__ = ["Mesh", "data_axes", "world_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps axis name -> size, in ``axis_names`` order; ``group``
    is the process group of the data axes (``None``: a world of one)."""

    axis_names: tuple
    shape: dict
    group: object = None


def data_axes(mesh) -> tuple[str, ...]:
    """The client/batch axes: everything except ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def world_mesh(shape=None, axis_names=("data", "model")) -> Mesh:
    """The mesh of this process's world: ``torch.distributed``'s default
    group when it is initialized, else a world of one.

    ``shape`` (one size per axis, default ``(world, 1)``) must multiply to
    the world size, and the ``model`` axis must be 1: the port shards no
    tensor, so every rank is one data-parallel client cohort.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = tuple(shape) if shape else (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name {axis_names}")
    sizes = dict(zip(axis_names, shape))
    if sizes.get("model", 1) != 1:
        raise ValueError("the port runs data parallelism only: the model "
                         f"axis must be 1, got {sizes['model']}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks;"
                         f" the world has {world}")
    group = dist.group.WORLD if world > 1 else None
    return Mesh(tuple(axis_names), sizes, group)
