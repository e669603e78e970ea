"""Process groups, device meshes and sharding helpers on ``torch.distributed``.

Counterpart of ``ergo_uvo_tpu/dist/mesh.py``.  JAX runs one controller over
every device of a ``Mesh``; here every rank is its own process (SPMD), one
device a rank, and a mesh is a ``DeviceMesh`` over the initialized world.

* :func:`init_world` starts the world (the counterpart of the tools'
  ``jax.distributed.initialize``): NCCL for the card, gloo for the CPU,
  with a timeout on every collective.
* :func:`make_mesh` and :func:`make_mesh_2d` build the 1-D ``('data',)`` and
  the 2-D ``('kf', 'lm')`` meshes; a CUDA mesh needs an NCCL world and a CPU
  mesh a gloo world, and a mismatch raises.
* :func:`landmark_sharding` and :func:`replicated` give the DTensor
  placements that match JAX's ``NamedSharding``; :func:`local_rows` gives a
  rank its contiguous block of a global array, which is what
  ``jax.device_put`` with such a sharding hands each device.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ergo_uvo_tpu_torch.device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def init_world(
    rank: int,
    world_size: int,
    device: torch.device | str | None = None,
    init_method: str | None = None,
    timeout: timedelta = timedelta(seconds=300),
    local_rank: int | None = None,
) -> torch.device:
    """Join this process to a world of ``world_size`` ranks; returns its device.

    ``device=None`` is the card (and raises where there is none).  On the
    card the process takes ``cuda:<local_rank>`` (default: ``rank``, one
    host; the index of a CUDA ``device`` is not used) before the NCCL group
    starts, and the group is bound to it; on the
    CPU the group runs on gloo.  ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``); ``timeout`` bounds every collective.
    """
    device = resolve_device(device)  # None: the card, and raises without one
    if device.type == "cuda":
        device = torch.device("cuda", rank if local_rank is None else local_rank)
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(_backend(device), init_method=init_method or "env://",
                            rank=rank, world_size=world_size, timeout=timeout, **kwargs)
    return device


def _backend(device: torch.device) -> str:
    if device.type not in _BACKEND:
        raise ValueError(f"no process-group backend for a {device.type} mesh")
    return _BACKEND[device.type]


def _mesh_of(device, shape, names) -> DeviceMesh:
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_world (or dist.init_process_group) first")
    backend = dist.get_backend()
    if backend != _backend(device):
        raise RuntimeError(
            f"a {device.type} mesh runs on {_backend(device)}, the world runs on {backend}")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} over a world of {world} ranks: "
                         "every rank of the world is one device of the mesh")
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))


def make_mesh(num_devices: int | None = None, axis_name: str = "data",
              device: torch.device | str | None = None) -> DeviceMesh:
    """1-D mesh over the world's ranks (``num_devices``, when given, must be
    the world size).  ``device=None`` is the card."""
    return _mesh_of(device, (num_devices or _world_size(),), (axis_name,))


def make_mesh_2d(n_kf: int, n_lm: int | None = None, kf_axis: str = "kf", lm_axis: str = "lm",
                 device: torch.device | str | None = None) -> DeviceMesh:
    """2-D ``(kf_axis, lm_axis)`` mesh: keyframe/window axis x landmark axis,
    ``n_kf * n_lm`` = the world size (``n_lm=None``: the world over ``n_kf``)."""
    if n_lm is None:
        n_lm = _world_size() // n_kf
    return _mesh_of(device, (n_kf, n_lm), (kf_axis, lm_axis))


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def landmark_sharding(mesh: DeviceMesh, rank: int, lm_axis: int, axis_name: str = "data"):
    """Placements that shard dimension ``lm_axis`` of a rank-``rank`` array
    over the mesh dimension ``axis_name``, replicated over the others."""
    from torch.distributed.tensor import Replicate, Shard  # ~1 s to import: only here

    if not 0 <= lm_axis < rank:
        raise ValueError(f"dimension {lm_axis} of a rank-{rank} array")
    return [Shard(lm_axis) if name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh):
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``."""
    return resolve_device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis_name)]


def local_rows(x, mesh: DeviceMesh, axis_name: str = "data", dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``: block ``i`` of
    ``n`` equal blocks, ``i`` this rank's coordinate on ``axis_name`` (a
    numpy array comes back as a tensor view of it)."""
    x = torch.as_tensor(x)
    n = axis_size(mesh, axis_name)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} over {n} shards")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis_name) * size, size)


def peer(mesh: DeviceMesh, axis_name: str, offset: int) -> int:
    """The global rank ``offset`` steps along ``axis_name`` from this rank
    (cyclic), the other coordinates kept."""
    coord = list(mesh.get_coordinate())
    d = mesh.mesh_dim_names.index(axis_name)
    coord[d] = (coord[d] + offset) % mesh.shape[d]
    return int(mesh.mesh[tuple(coord)])


def all_reduce_packed(parts, group=None) -> list[torch.Tensor]:
    """Sum every tensor of ``parts`` over ``group`` in one ``all_reduce`` of
    a flat buffer; returns the sums, shaped as the parts."""
    packed = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(packed, group=group)
    return [v.view(p.shape) for v, p in zip(packed.split([p.numel() for p in parts]), parts)]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated along dimension 0, in group-rank order
    (a bool tensor travels as bytes)."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bool else x
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts)
    return out.view(torch.bool) if x.dtype == torch.bool else out
