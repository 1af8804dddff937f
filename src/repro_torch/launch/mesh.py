"""Meshes: a description the sharding rules read, and live device meshes.

Counterpart of ``repro/launch/mesh.py``. Production meshes:

  Single pod : (16, 16)    axes ('data', 'model')          = 256 ranks
  Multi pod  : (2, 16, 16) axes ('pod', 'data', 'model')   = 512 ranks

Axis roles, as in the reference:
  pod   - pure data parallelism across pods (parameters not sharded there)
  data  - FSDP: batch and parameter / optimizer sharding
  model - TP: attention heads and FFN width, the vocab, long-sequence caches

Two kinds of mesh object serve the rules. :class:`MeshSpec` names axes and
sizes and needs no process group, so the rules run on it anywhere (the
tests hold them against the reference's ``AbstractMesh``). A live
``torch.distributed.device_mesh.DeviceMesh`` (:func:`make_mesh`) places
DTensors. ``axis_names``, ``axis_size``, ``dp_axes`` and ``fsdp_axis``
accept either.

Nothing here touches ``torch.distributed`` when imported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a mesh, in mesh order."""
    sizes: Tuple[int, ...]
    names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.names):
            raise ValueError(f"mesh sizes {self.sizes} for axes {self.names}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as the reference's ``Mesh.shape``."""
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


PRODUCTION = {False: MeshSpec((16, 16), ("data", "model")),
              True: MeshSpec((2, 16, 16), ("pod", "data", "model"))}


def production_spec(multi_pod: bool = False) -> MeshSpec:
    return PRODUCTION[bool(multi_pod)]


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a :class:`MeshSpec` or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshSpec):
        return mesh.names
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the rules need a DeviceMesh with mesh_dim_names")
    return tuple(names)


def axis_size(mesh, name: str) -> int:
    if isinstance(mesh, MeshSpec):
        return mesh.shape[name]
    return mesh.size(axis_names(mesh).index(name))


def dp_axes(mesh) -> tuple:
    """Axes that shard the batch (pure DP + FSDP)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def fsdp_axis(mesh) -> str:
    """Axis that shards parameters and optimizer state (within a pod)."""
    return "data"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda"):
    """A live ``DeviceMesh`` of ``shape`` over the ranks of the default
    process group (started by the caller), ranks laid out row-major. The
    world must hold at least ``prod(shape)`` ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    need = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world < need:
        raise RuntimeError(f"mesh {shape} needs {need} ranks, the process "
                           f"group has {world}")
    if world == need:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) pod or (2, 16, 16) multi-pod mesh over the default
    process group; raises when the world is smaller (the dry-run runs on a
    ``fake`` group of 256 or 512 ranks)."""
    spec = production_spec(multi_pod)
    return make_mesh(spec.sizes, spec.names, device_type=device_type)
