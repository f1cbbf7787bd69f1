"""The world of ranks the sharded paths run over — the counterpart of the
JAX package's ``parallel/mesh.py``.

The JAX package shards pixel tiles over a ``jax.sharding.Mesh`` of devices
and runs one program on all of them (SPMD).  Here every rank is one process
driving one device, in a ``torch.distributed`` process group, and a
``Mesh`` is this process's place in it: the group, its rank, the group's
size and the device it computes on, a 1-D mesh along ``TILE_AXIS`` as
JAX's.  It is a plain record, not ``torch.distributed.device_mesh.
DeviceMesh``: the sharded steps slice their pixels by hand and issue their
one collective themselves, so DTensor's layouts would add nothing.  Scene
parameters are replicated on every rank; rays are independent, so the only
cross-rank reductions are the loss and gradient sums of a fit step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a 1-D mesh: ``group`` (a process group; None
    is the default group), ``rank`` in it, its ``size``, and the ``device``
    this rank computes on."""
    group: Any
    rank: int
    size: int
    device: torch.device


def make_mesh(ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The 1-D mesh over every rank of the initialized default process
    group (``parallel/multihost.py::initialize_multihost``), or over the
    global ``ranks`` given: then every rank of the world must call it
    (``torch.distributed.new_group`` is collective), and a rank outside
    ``ranks`` gets None.  The mesh's device is the rank's card under NCCL
    (``torch.cuda.current_device()``) and the CPU under gloo.
    Raises where no process group is up: nothing here falls back to one
    process."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize_multihost (or torch.distributed."
                           "init_process_group) first")
    group = None
    if ranks is not None and list(ranks) != list(range(
            dist.get_world_size())):
        group = dist.new_group(list(ranks))
        if dist.get_rank() not in ranks:
            return None
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=device)


def replicated(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``tensor`` made equal on every rank of ``mesh``: broadcast in place
    from its rank 0 (JAX: a replicated ``NamedSharding``)."""
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    dist.broadcast(tensor, src=src, group=mesh.group)
    return tensor


def shard_bounds(n: int, rank: int, world: int):
    """(start, stop) of ``rank``'s equal slice of a leading axis of ``n``,
    which ``world`` must divide."""
    if n % world:
        raise ValueError(f"a leading axis of {n} does not split into "
                         f"{world} equal shards")
    m = n // world
    return rank * m, (rank + 1) * m


def row_sharded(tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``tensor``'s leading axis (JAX: a
    ``NamedSharding`` with ``P(axis)``), a view."""
    start, stop = shard_bounds(tensor.shape[0], mesh.rank, mesh.size)
    return tensor[start:stop]


def all_reduce_sum(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``flat`` summed over the ranks of ``mesh``, in place: the one
    collective of a sharded step."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return flat
