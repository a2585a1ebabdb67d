"""Process-group start-up and the port's meshes.

The counterpart of ``repro.launch.mesh``.  JAX sees every local device in
one process; the port runs one process per card under ``torch.distributed``
(``torchrun --nproc-per-node N``), and a mesh is a ``DeviceMesh`` over the
processes' group:

  * ``init_distributed`` joins the process group from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
    / ``MASTER_PORT``) or from explicit arguments: NCCL on the card, with
    ``torch.cuda.set_device(local_rank)``, so that ``cuda`` (what
    ``resolve_device(None)`` gives) is that card, gloo on the CPU.  A one-rank group with no
    ``init_method`` keeps its store in the process (``HashStore``), so a
    single process needs no port;
  * ``camera_device_mesh`` is the 1-D ("camera",) mesh over the whole
    group (``sharding.rules.camera_mesh`` is the fleet's entry);
  * ``shutdown`` drops the sharded episode graphs, which hold the
    group's communicator, and leaves the group.

``make_host_mesh`` and ``make_production_mesh`` (the LM's data x model
meshes) wait for the LM's slice.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def under_launcher() -> bool:
    """Whether this process was started by ``torchrun`` (or another
    launcher that sets the process group's environment)."""
    return "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ


# audit: allow(host-sync) ranks and sizes are environment strings
def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


# audit: allow(host-sync) ranks and sizes are host ints, never tensors
def init_distributed(device_type: Optional[str] = None, *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     init_method: Optional[str] = None) -> None:
    """Join (or, for a one-rank world, make) the default process group.

    ``device_type`` ``"cuda"`` (default when a card is present) uses NCCL
    and binds this process to card ``local_rank``; ``"cpu"`` uses gloo.
    Arguments left None come from torchrun's environment (rank 0 of 1 when
    there is none).  ``init_method`` defaults to ``env://`` when
    ``MASTER_ADDR`` is set and to an in-process store for one rank.  A
    second call is a no-op."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    world_size = (_env_int("WORLD_SIZE", 1) if world_size is None
                  else int(world_size))
    local_rank = (_env_int("LOCAL_RANK", rank) if local_rank is None
                  else int(local_rank))
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    kw = {}
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of several ranks needs an init_method "
                             "or torchrun's MASTER_ADDR / MASTER_PORT")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method
    if device_type == "cuda":
        kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)


def shutdown() -> None:
    """Drop the sharded episode graphs (``fleet.drop_mesh_graphs``: each
    holds this group's communicator) and leave the process group (if
    any)."""
    from repro_torch.core.fleet import drop_mesh_graphs
    drop_mesh_graphs()
    if dist.is_initialized():
        dist.destroy_process_group()


def group_device_type() -> str:
    """``"cuda"`` for an NCCL group, ``"cpu"`` otherwise."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def camera_device_mesh():
    """The 1-D ("camera",) ``DeviceMesh`` over every rank of the default
    group (which must be up)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(group_device_type(), (dist.get_world_size(),),
                            mesh_dim_names=("camera",))
