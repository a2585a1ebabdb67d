"""The fleet's camera mesh: layout and collectives (the camera half of
``repro.sharding.rules``).

The JAX package shard_maps the fleet over a ("camera",) mesh of the
devices one process sees.  The port runs one process per card under
``torch.distributed`` (``launch.mesh``), and the per-rank code is the
shard_map: each rank holds a contiguous block of cameras and runs the
per-camera stages on it with the ordinary kernels.

Layout: C cameras pad to ``c_pad = ceil(C / D) * D`` (``pad_cameras``) with
inert cameras; rank i holds rows ``[i * n_local, (i + 1) * n_local)``
(``camera_rows``).  ``scatter`` takes a global (C, ...) tensor to this
rank's rows (JAX's ``scatter`` inside the episode), ``gather`` concatenates
every rank's rows (JAX's ``all_gather(..., tiled=True)``, and the
``unshard`` / ``reshard_replicated`` pair around its control step: the
port's control runs replicated on every rank, so the gather is the whole
round trip).  ``gather`` is one ``all_gather`` over the mesh's group, on
NCCL inside the episode's CUDA graphs; it reads nothing on the host.

``shard_map_compat``, ``sharded_jit`` and ``cached_sharded_jit`` have no
counterpart: a process runs its own rows, and a graph key holds
``mesh_cache_key`` (world size, rank).  The LM half (``rules``,
``spec_for``, ``param_pspecs``, ...) waits for the LM's slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def camera_mesh(min_devices: int = 2):
    """The ("camera",) ``DeviceMesh`` over every rank of the default
    process group, or None when no group is up or it has fewer than
    ``min_devices`` ranks (a single process runs unsharded, as the JAX
    package's single-device runs skip shard_map).  On the card the group
    is NCCL and each rank owns its ``LOCAL_RANK``'s card
    (``launch.mesh.init_distributed``).  The mesh's group is the default
    group, so a second call makes no communicator."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    if dist.get_world_size() < min_devices:
        return None
    from repro_torch.launch.mesh import camera_device_mesh
    return camera_device_mesh()


def mesh_size(mesh) -> int:
    """Ranks of the camera axis (1 when unsharded)."""
    return 1 if mesh is None else int(mesh.size())


def mesh_rank(mesh) -> int:
    """This process's position on the camera axis (0 when unsharded)."""
    return 0 if mesh is None else int(mesh.get_local_rank())


def mesh_cache_key(mesh) -> Optional[Tuple[int, int]]:
    """Hashable identity of a mesh for graph caches: (world size, rank);
    None when unsharded."""
    return None if mesh is None else (mesh_size(mesh), mesh_rank(mesh))


def pad_cameras(n: int, mesh) -> int:
    """Smallest multiple of the camera-mesh size >= n (n itself when
    unsharded)."""
    d = mesh_size(mesh)
    return -(-n // d) * d


def local_count(n: int, mesh) -> int:
    """Cameras per rank of an n-camera fleet."""
    return pad_cameras(n, mesh) // mesh_size(mesh)


def camera_rows(n: int, mesh) -> Tuple[int, int]:
    """This rank's [lo, hi) rows of the padded n-camera fleet."""
    k = local_count(n, mesh)
    lo = mesh_rank(mesh) * k
    return lo, lo + k


def pad_leading(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """A camera-leading tensor padded to n rows with ``fill`` (inert
    cameras that the fleet computes and slices back off)."""
    if x.shape[0] == n:
        return x
    pad = torch.full((n - x.shape[0],) + tuple(x.shape[1:]), fill,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def scatter(x: torch.Tensor, mesh, fill=0) -> torch.Tensor:
    """A global (n, ...) tensor -> this rank's (n_local, ...) rows of its
    padded form (x itself when unsharded)."""
    if mesh is None:
        return x
    n = x.shape[0]
    lo, hi = camera_rows(n, mesh)
    return pad_leading(x, pad_cameras(n, mesh), fill)[lo:hi]


def expect_rows(x: torch.Tensor, n: int, mesh, what: str) -> torch.Tensor:
    """``x`` itself, checked to hold this rank's rows of an n-camera
    fleet (``local_count(n, mesh)``; all n unsharded).  Under a mesh the
    carry and the scene's params are always the rank's rows: a
    checkpoint's or a host scene's whole fleet is split where it comes in
    (``scatter``)."""
    k = local_count(n, mesh)
    if x.shape[0] != k:
        raise ValueError(f"{what}: expected this rank's {k} camera rows of "
                         f"{n}, got {x.shape[0]}")
    return x


def gather(x: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order: the
    (n_local, ...) rows of each rank -> (c_pad, ...).  One ``all_gather``
    over the mesh's group (NCCL on the card, capturable in a CUDA graph;
    gloo on the CPU); x itself when unsharded.  The result is contiguous
    (a host reduction over it then runs in the unsharded layout's order)."""
    if mesh is None:
        return x
    if dim != 0:
        return gather(x.movedim(dim, 0), mesh).movedim(0, dim).contiguous()
    if x.dtype == torch.bool:       # gloo has no bool: gather the bytes
        return gather(x.to(torch.uint8), mesh).to(torch.bool)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh_size(mesh))]
    dist.all_gather(parts, x, group=mesh.get_group("camera"))
    return torch.cat(parts, dim=0)


def agree(err: Optional[BaseException], values: Sequence[float], mesh,
          device) -> Tuple[Optional[BaseException], np.ndarray]:
    """The host decisions every rank must take alike, in one MAX
    all-reduce: whether any rank failed, and the largest of ``values``
    over the ranks.  Returns (this rank's own error, or a RuntimeError
    naming the last failing rank when only another rank failed; the
    values as float64).  Unsharded: (err, values) as given.

    A rank's wall time, a fault or a preemption signal is its own; the
    branch taken on it (a rung of the SLO ladder, a retry, a checkpoint)
    decides which collectives come next, so every rank decides on the
    agreed values.  This reads the result on the host: call it at a
    boundary, after the harvest."""
    v = np.asarray([0.0] + [float(x) for x in values], np.float64)
    if mesh is None:
        return err, v[1:]
    if err is not None:
        v[0] = mesh_rank(mesh) + 1
    t = torch.from_numpy(v).to(device)
    dist.all_reduce(t, dist.ReduceOp.MAX, group=mesh.get_group("camera"))
    v = t.cpu().numpy()
    if err is None and v[0] > 0:
        err = RuntimeError(f"camera-mesh rank {int(v[0]) - 1} failed")
    return err, v[1:]


def is_writer(mesh) -> bool:
    """Whether this rank writes the fleet's files and prints its reports
    (rank 0 of the mesh; always when unsharded)."""
    return mesh_rank(mesh) == 0
