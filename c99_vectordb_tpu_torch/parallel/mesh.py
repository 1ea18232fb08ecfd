"""Rank meshes and their collectives, over torch.distributed.

Counterpart of the JAX package's parallel/mesh.py. One process per rank
(SPMD): every rank builds the same mesh and calls the same index methods
with the same arguments, as a JAX multi-controller program does. The
corpus axis (database rows) maps to the `data` axis; the embedding axis
optionally to a `model` axis; ("host", "chip") factors the ranks for the
two-level merge.

With no initialized process group the world has one rank: the mesh then
has one rank and every collective is the identity (the CLI's case on one
card, as the JAX CLI's on one chip). A mesh of more ranks needs a process
group; asking for one without it raises.

Collectives carry only small operands (the (B, k) candidates, a D-wide
maximum, the 2-D route's partial products). Under NCCL they stay on the
card; under gloo (the CPU tests, several ranks sharing one card) they move
through the host explicitly: `.cpu()` before, `.to(device)` after.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..utils.runtime import resolve_device


class Mesh:
    """A named grid of ranks and the device this rank computes on.

    axis_names and shape ({axis: size}) follow the JAX Mesh; coordinate()
    is this rank's index along an axis; group() the process group of the
    ranks that share every other coordinate with it (None on a one-rank
    axis). `device_mesh` is the torch DeviceMesh behind a mesh of more
    than one rank."""

    def __init__(self, axis_names: tuple[str, ...], sizes: tuple[int, ...], device,
                 device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.backend = dist.get_backend() if device_mesh is not None else None

    def coordinate(self, axis: str) -> int:
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        if self.shape[axis] == 1:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def world_size() -> int:
    """Ranks of the initialized process group, or 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank_device(device) -> torch.device:
    """The device rule (utils/runtime.resolve_device); under NCCL an
    unindexed CUDA device is this rank's card, cuda:LOCAL_RANK."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
    return dev


def _build(axis_names: tuple[str, ...], sizes: tuple[int, ...], device) -> Mesh:
    need = math.prod(sizes)
    world = world_size()
    if need != world:
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {need} ranks needs an initialized torch.distributed process "
                f"group (without one the world has 1 rank)")
        raise ValueError(f"mesh needs {need} ranks, the world has {world}")
    dev = _rank_device(device)
    if world == 1:
        return Mesh(axis_names, sizes, dev)
    from torch.distributed.device_mesh import DeviceMesh

    # The DeviceMesh's device type is where its collectives run: the card
    # under NCCL, the host under gloo.
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.arange(world).reshape(sizes)
    return Mesh(axis_names, sizes, dev,
                DeviceMesh(mesh_type, grid, mesh_dim_names=tuple(axis_names)))


def make_mesh(n_data: int | None = None, n_model: int = 1, device=None) -> Mesh:
    """A ("data", "model") mesh over the world's ranks (n_data defaults to
    world // n_model)."""
    if n_data is None:
        n_data = max(1, world_size() // n_model)
    return _build(("data", "model"), (n_data, n_model), device)


def make_host_chip_mesh(n_hosts: int, n_chips: int, device=None) -> Mesh:
    """A ("host", "chip") mesh for the two-level merge: the merge reduces
    within `chip` first, so only k candidates per host cross the outer
    axis."""
    return _build(("host", "chip"), (n_hosts, n_chips), device)


def default_data_mesh(device=None) -> Mesh:
    """Every rank of the world on a 1-D `data` axis: one rank without a
    process group (the sharded families' default when no mesh is given)."""
    return _build(("data",), (world_size(),), device)


# -- collectives, one per axis; the identity on a one-rank axis ---------------


def all_gather_axis(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(...) on every rank of `axis` -> (S, ...) stacked in axis order, on
    t's device."""
    s = mesh.shape[axis]
    if s == 1:
        return t[None]
    group = mesh.group(axis)
    if mesh.backend == "nccl":
        out = torch.empty((s, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out
    src = t.detach().cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(s)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_axis(t: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """Elementwise `op` ("sum" or "max") of t over the ranks of `axis`, on
    t's device (t itself on a one-rank axis)."""
    if mesh.shape[axis] == 1:
        return t
    group = mesh.group(axis)
    if mesh.backend == "nccl":
        out = t.clone()
        dist.all_reduce(out, op=_OPS[op], group=group)
        return out
    out = t.detach().cpu().clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out.to(t.device)


def all_gather_axes(t: torch.Tensor, mesh: Mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """Concatenate every shard's (n, ...) block along dim 0 in shard order
    (row-major over `axes`, as a JAX P(axes) sharding lays them out)."""
    for axis in reversed(axes):
        g = all_gather_axis(t, mesh, axis)
        t = g.reshape(g.shape[0] * g.shape[1], *g.shape[2:])
    return t


def all_reduce_axes(t: torch.Tensor, mesh: Mesh, axes: tuple[str, ...],
                    op: str = "sum") -> torch.Tensor:
    for axis in reversed(axes):
        t = all_reduce_axis(t, mesh, axis, op)
    return t
