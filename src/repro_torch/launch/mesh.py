"""Meshes: the production meshes, the debug mesh, and a mesh for the world
size the trainer runs at.

The counterpart of `src/repro/launch/mesh.py`: a `DeviceMesh` with the
reference's axis names (`"pod"`, `"data"`, `"model"`). Functions only:
importing this module touches no process group. Building a `DeviceMesh`
needs the default process group initialised with the mesh's world size;
`MeshShape` stands for a mesh where only the axis names and sizes matter
(the sharding rules at production size), and needs no process at all.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, with `DeviceMesh`'s attribute names
    (`shape`, `mesh_dim_names`), for the rules that only read those."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or a `MeshShape`, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` of `shape` named `axes` over the default process
    group, whose world size must be the product of `shape`."""
    shape, axes = tuple(shape), tuple(axes)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs a "
                         f"world size of {need}, this process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks ("pod", "data", "model")."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device_type)


def production_mesh_shape(multi_pod: bool = False) -> MeshShape:
    """The production mesh's names and sizes, without its ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return MeshShape(shape, axes)


def make_debug_mesh(devices: int = 8, device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for tests: (devices//2, 2) ("data", "model")."""
    if devices % 2:
        raise ValueError(f"the debug mesh needs an even world size, "
                         f"got {devices}")
    return make_mesh((devices // 2, 2), ("data", "model"), device_type)


def make_world_mesh(production: bool = False,
                    device_type: str = "cuda") -> DeviceMesh:
    """The trainer's mesh, as the reference's `launch/train.py` picks it:
    the production mesh when asked for (256 ranks), the debug mesh of
    min(8, world) ranks when there is more than one (a world above 8 is
    refused: a `DeviceMesh` spans the whole process group), else (1, 1)."""
    if production:
        return make_production_mesh(False, device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1:
        return make_debug_mesh(min(8, world), device_type)
    return make_mesh((1, 1), ("data", "model"), device_type)
