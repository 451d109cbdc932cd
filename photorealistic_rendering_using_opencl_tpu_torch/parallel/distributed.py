"""Joining a process group, the 1-D ``rays`` mesh and a rank's slice.

Port of ``photorealistic_rendering_using_opencl_tpu/parallel/distributed.py``.
Where the reference runs one SPMD program over every device of a
``jax.distributed`` cluster, here each rank is one process that drives one
device: NCCL between cards, gloo on the CPU and wherever ranks share a card
(NCCL refuses two ranks on one GPU).  Every rank loads the whole scene on
its device, pixels shard over the ``rays`` axis, and the only collectives
are ``parallel/render.py``'s: one gather of a rendered frame, and a train
step's two all-reduces.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)

RAYS_AXIS = "rays"


def rank_world(group=None) -> tuple[int, int]:
    """(this rank, the group's size); (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def rank_device(device=DEFAULT_DEVICE, local_rank: int | None = None
                ) -> torch.device:
    """This rank's device: the CPU, or card ``local_rank`` (by default
    ``LOCAL_RANK`` as ``torchrun`` sets it, else the group rank) modulo the
    host's cards."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank_world()[0]))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device=DEFAULT_DEVICE) -> None:
    """Join the default process group.

    The arguments, or torch's own environment as ``torchrun`` sets it
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The
    coordinator is a ``host:port``, or any ``init_method`` URL
    (``tcp://``, ``file://``).  The backend is NCCL when each of the
    host's ranks (``LOCAL_WORLD_SIZE``, else the world) has a card of its
    own, else gloo: the CPU, or more ranks than cards.  With neither a
    coordinator nor a world size it is a no-op, as in one process; so is
    a call in a process that has joined a group.
    """
    if dist.is_initialized():
        return
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = "env://"
    world = num_processes
    if world is None and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
    if addr is None and world is None:
        return
    world = 1 if world is None else world
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", 0)))
    if addr is None or "://" not in addr:
        addr = "env://" if addr is None else f"tcp://{addr}"
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if (int(os.environ.get("LOCAL_WORLD_SIZE", world))
                <= torch.cuda.device_count()):
            backend = "nccl"
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank)


def global_mesh(device=DEFAULT_DEVICE):
    """A 1-D ``DeviceMesh`` named ``("rays",)`` over every rank of the
    default group (``initialize`` first)."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: no process group (call "
                           "initialize() under torchrun, or with a "
                           "coordinator, first)")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=(RAYS_AXIS,))


def local_shard_bounds(n: int) -> tuple[int, int]:
    """[start, end) of this rank's slice of a length-n batch: the
    reference's ``per = ceil(n / world)`` slices, with both ends clamped
    to n (the reference lets a last rank's start pass n)."""
    rank, world = rank_world()
    per = (n + world - 1) // world
    return min(rank * per, n), min((rank + 1) * per, n)
