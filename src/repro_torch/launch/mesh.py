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

The CLIs (``launch/train.py``, ``launch/serve.py``) start their ranks
here: :func:`mesh_dims` reads ``--devices`` / ``--mesh``,
:func:`process_group` gives a rank its mesh and device, and
:func:`spawn` starts local gloo ranks on the CPU.

Nothing here touches ``torch.distributed`` when imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from typing import Callable, Dict, Sequence, Tuple


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


def live_mesh(mesh):
    """``mesh`` where it can place tensors (a ``DeviceMesh``, or None);
    a :class:`MeshSpec` raises ``TypeError``: it describes a mesh and has
    no process group."""
    if isinstance(mesh, MeshSpec):
        raise TypeError(
            "a MeshSpec describes a mesh and has no process group: serve on "
            "a live DeviceMesh (launch.mesh.make_mesh)")
    return mesh


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


# -- the CLIs' ranks ---------------------------------------------------------
def mesh_dims(args, *, over: str = "data"):
    """The (data, model) mesh a CLI's ``args`` ask for, or None for one
    device: ``--mesh D,M``, or ``--devices N`` alone over the axis
    ``over`` ((N, 1) for 'data', (1, N) for 'model'). Raises ValueError,
    naming the flag, where the flags disagree with each other, with the
    launcher's world or with the cards there are, and where more than one
    rank on the card has no launcher (only ``--device cpu`` starts its
    ranks in-process)."""
    import torch
    import torch.distributed as dist

    if args.mesh is None and args.devices is None:
        return None
    if args.mesh is None:
        dims = (args.devices, 1) if over == "data" else (1, args.devices)
    else:
        try:
            dims = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            dims = ()
        if len(dims) != 2 or min(dims) < 1:
            raise ValueError(f"--mesh {args.mesh!r}: expected D,M (two "
                             "positive integers, data and model)")
    n = args.devices if args.devices is not None else math.prod(dims)
    if n < 1 or math.prod(dims) != n:
        raise ValueError(f"--mesh {dims[0]},{dims[1]} holds "
                         f"{math.prod(dims)} ranks, --devices {n}")
    world = os.environ.get("WORLD_SIZE")
    if world is not None and int(world) != n:
        raise ValueError(f"--devices {n} under a launcher of {world} ranks")
    if (args.device or "cuda").startswith("cuda"):
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world is None and n > cards:
            raise ValueError(f"--devices {n}: NCCL takes one rank a card and "
                             f"there are {cards} (pass --device cpu for "
                             "gloo ranks on the CPU)")
        if world is None and n > 1 and not dist.is_initialized():
            raise ValueError(f"--devices {n} on the card: start the ranks "
                             f"with torchrun --nproc-per-node {n} (NCCL, one "
                             "rank a card); only --device cpu starts gloo "
                             "ranks here")
    return dims


@contextlib.contextmanager
def process_group(args, dims):
    """This rank's mesh and device. Uses the process group that is there
    (a launcher's, a spawned rank's, a caller's); else starts one from the
    launcher's environment, or an in-process group of one rank (gloo with
    ``--device cpu``, NCCL on the card), and destroys what it started."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.device import resolve_device

    device = resolve_device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    started = not dist.is_initialized()
    if started and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    elif started:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = torch.device("cuda", local)
            torch.cuda.set_device(device)
        yield make_mesh(dims, ("data", "model"),
                        device_type=device.type), device
    finally:
        if started:
            dist.destroy_process_group()


def silent(*args, **kwargs):
    """Where a rank other than 0 would print."""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def rank_main(rank: int, entry: Callable, argv, world: int, port: int):
    """One spawned gloo rank: ``entry(argv)`` (a CLI's module-level entry
    point) inside a process group of ``world`` ranks; a nonzero code it
    returns is this process's exit code."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        rc = entry(argv)
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(rc)


def spawn(entry: Callable, argv, world: int) -> int:
    """Run ``world`` local gloo ranks of ``entry(argv)`` and join them; 1
    if any rank failed."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    try:
        mp.start_processes(rank_main,
                           args=(entry, list(argv), world, _free_port()),
                           nprocs=world, join=True, start_method="spawn")
    except ProcessException as e:
        print(f"ERROR: a rank failed: {e}", file=sys.stderr)
        return 1
    return 0
