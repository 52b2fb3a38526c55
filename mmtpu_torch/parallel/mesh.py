"""Meshes of ranks and which block of a config axis a rank holds (port of
:mod:`mmtpu.parallel.mesh`).

mmtpu's mesh is one controller's grid of devices.  The port's is a grid of
processes: one process per rank of a ``torch.distributed`` world, each
computing on its own device.  A :class:`Mesh` lays the world's ranks out on
named axes and keeps, for each axis, the process group of the ranks that
share this rank's place on every other axis: the group that the axis's
collectives run over.

Backends: gloo for CPU ranks, NCCL for CUDA ranks with one card each, and
an explicit ``backend="gloo"`` for CUDA ranks that share one card (NCCL
refuses two ranks on one device).  Nothing switches backend or device by
itself: the backend follows the device the caller names
(:func:`default_backend`) unless the caller names another.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """This rank's device: ``"cuda"`` without an index is the card of the
    rank's ``LOCAL_RANK`` (0 outside torchrun), made current; an indexed
    card (ranks that share one card name it) and the CPU stay as given."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def init_world(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Make sure a process group is up and return this rank's device: the
    group of ``torchrun`` (:func:`mmtpu_torch.parallel.multihost.init_multihost`)
    where its environment is set, else a group of this one process (an
    in-memory store), so that a mesh of one rank runs the collective code
    path of a larger one.  Idempotent."""
    from mmtpu_torch.parallel.multihost import init_multihost

    device = rank_device(device)
    if not init_multihost(device, backend):
        dist.init_process_group(backend or default_backend(device), store=dist.HashStore(),
                                world_size=1, rank=0)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's ranks on named axes.

    ``ranks`` holds the world ranks in the mesh's shape, ``coords`` this
    rank's place in it, and ``groups[axis]`` the process group of the ranks
    that differ from this one only along ``axis`` (one rank where the axis
    has size 1).  Every process of the world holds the same layout."""

    axis_names: Tuple[str, ...]
    ranks: np.ndarray
    coords: Tuple[int, ...]
    groups: Dict[str, object]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.ranks.shape)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    @property
    def is_main(self) -> bool:
        """The rank that writes a run's artifacts and prints its lines."""
        return not any(self.coords)


def build_mesh(shape: Sequence[int], axis_names: Sequence[str],
               backend: Optional[str] = None) -> Mesh:
    """A mesh of ``shape`` over every rank of the world, in rank order.
    Collective over the world: every process calls it alike (each creates
    every axis group, in one order)."""
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} for axes {tuple(axis_names)}")
    world, me = dist.get_world_size(), dist.get_rank()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {int(np.prod(shape))} ranks; the world "
                         f"has {world} (each process is one rank of the mesh)")
    ranks = np.arange(world).reshape(tuple(shape))
    groups = {}
    for ax, name in enumerate(axis_names):
        for line in np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax]):
            group = dist.new_group(line.tolist(), backend=backend)
            if me in line:
                groups[name] = group
    coords = tuple(int(c) for c in np.argwhere(ranks == me)[0])
    return Mesh(tuple(axis_names), ranks, coords, groups)


def make_mesh(n_ranks: Optional[int] = None, axis_names: Sequence[str] = ("config",),
              backend: Optional[str] = None) -> Mesh:
    """Every rank on the first axis, any further axes of size 1 (mmtpu's
    default: the sweep's "config" axis over all devices).  ``n_ranks``, if
    given, must be the world's size.  The world must be up
    (:func:`init_world`)."""
    n = dist.get_world_size() if n_ranks is None else n_ranks
    return build_mesh([n] + [1] * (len(axis_names) - 1), axis_names, backend)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Which block of a leading config axis this rank holds: a contiguous
    block per rank along ``axis`` (the first ``K % n`` ranks hold one more),
    or all of it where ``axis`` is None (replicated)."""

    mesh: Mesh
    axis: Optional[str]

    def block(self, k: int) -> slice:
        if self.axis is None:
            return slice(0, k)
        n, i = self.mesh.size(self.axis), self.mesh.index(self.axis)
        base, extra = divmod(k, n)
        lo = i * base + min(i, extra)
        return slice(lo, lo + base + (i < extra))

    def gather(self, obj) -> list:
        """Every rank's ``obj`` along the axis, in rank order (one
        ``all_gather_object``; ``[obj]`` when replicated)."""
        if self.axis is None:
            return [obj]
        out = [None] * self.mesh.size(self.axis)
        dist.all_gather_object(out, obj, group=self.mesh.groups[self.axis])
        return out


def config_sharding(mesh: Mesh, axis: str = "config") -> Sharding:
    """Shard the leading (config) axis across ``axis`` of the mesh."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    """Every rank holds the whole leading axis (shared data)."""
    return Sharding(mesh, None)
