"""Layout rules and collectives of the port's meshes: the fleet's camera
mesh and the LM's (data, model) mesh (``repro.sharding.rules``).

**The camera half.**

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
``mesh_cache_key`` (world size, rank).

**The LM half** (logical axis -> mesh axis, MaxText style): ``rules``,
``spec_for``, ``safe_spec``, ``param_pspecs``, ``batch_axes``,
``fit_batch_axes``, ``data_spec``, ``cache_spec`` and ``constrain`` are
plain functions of a mesh's ``axis_names`` and ``shape`` (a dict of axis
sizes), so they take the port's ``launch.mesh.LMMesh`` and any stand-in
alike.  A spec is a tuple with one entry per tensor dim: None
(replicated), a mesh axis name, or a tuple of axis names that shard one
dim together (``("pod", "data")``), as JAX's ``PartitionSpec``.  The
weights follow JAX's rules exactly: Megatron TP over "model" for the
``mlp``, ``heads``, ``kv_heads``, ``vocab`` and ``experts`` axes, FSDP over
"data" (``("pod", "data")`` with ``fsdp_over_pod``) for ``embed``, and
the ``"fsdp"`` and ``"dp"`` policies.  ``param_placements`` turns a spec
into DTensor placements (``Shard(dim)`` / ``Replicate()`` per mesh dim),
and ``local_slice`` into this rank's piece of a whole tensor.
``param_shardings`` (a NamedSharding per leaf) has no counterpart: a
rank holds its slice, and the placements say where the rest is.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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


# -- the LM half: logical axis -> mesh axis ------------------------------------

Spec = Tuple[Any, ...]        # per dim: None, an axis name, or a tuple of them
_NON_WEIGHT = ("layers", "norm", "state", "conv", "act_seq", "act_embed",
               "cache_seq")


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def axes_size(mesh, axes) -> int:
    """Ranks along ``axes`` (None, one name, or a tuple of names)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def rules(mesh, fsdp_over_pod: bool = False, policy: str = "2d"
          ) -> Dict[str, Tuple[str, ...]]:
    """Logical axis name -> tuple of mesh axes (JAX's table)."""
    axes = _names(mesh)
    has_pod = "pod" in axes
    all_axes = tuple(a for a in ("pod", "data", "model") if a in axes)
    if policy == "dp":
        # small models: every weight replicated, DP over every axis
        return {k: () for k in ("embed", "mlp", "heads", "kv_heads", "vocab",
                                "experts") + _NON_WEIGHT} | {
            "batch": all_axes, "cache_batch": all_axes}
    if policy == "fsdp":
        # ZeRO style: matrices sharded on "embed" over the data axes, no TP
        # on the body; the embedding stays vocab-parallel over "model"
        fsdp_t = ("pod", "data") if has_pod else ("data",)
        return {k: () for k in ("mlp", "heads", "kv_heads", "experts")
                + _NON_WEIGHT} | {
            "embed": fsdp_t, "vocab": ("model",),
            "batch": all_axes, "cache_batch": all_axes}
    fsdp: Tuple[str, ...] = ("data",)
    if fsdp_over_pod and has_pod:
        fsdp = ("pod", "data")
    batch: Tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    return {"embed": fsdp, "mlp": ("model",), "heads": ("model",),
            "kv_heads": ("model",), "vocab": ("model",),
            "experts": ("model",), "layers": (), "norm": (), "state": (),
            "conv": (), "batch": batch, "act_seq": (), "act_embed": (),
            "cache_batch": batch, "cache_seq": ()}


def spec_for(d, mesh, fsdp_over_pod: bool = False, policy: str = "2d"
             ) -> Spec:
    """The spec of one ParamDef from its ``logical_axes``."""
    r = rules(mesh, fsdp_over_pod, policy)
    parts = []
    for ax in d.logical_axes:
        mapped = r.get(ax, ()) if ax is not None else ()
        if not mapped:
            parts.append(None)
        elif len(mapped) == 1:
            parts.append(mapped[0])
        else:
            parts.append(tuple(mapped))
    return tuple(parts)


def safe_spec(shape: Sequence[int], spec: Spec, mesh) -> Spec:
    """Drop the mesh axes that do not divide their dim (replicate it)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(ax if int(dim) % axes_size(mesh, ax) == 0 else None
                 for dim, ax in zip(shape, spec))


def param_pspecs(defs: Any, mesh, fsdp_over_pod: bool = False,
                 policy: str = "2d") -> Any:
    """The tree of (divisibility-safe) specs of a ParamDef tree."""
    from repro_torch.common.params import map_defs
    return map_defs(lambda d: safe_spec(
        d.shape, spec_for(d, mesh, fsdp_over_pod, policy), mesh), defs)


def batch_axes(mesh, policy: str = "2d") -> Tuple[str, ...]:
    """The data-parallel axes of a policy."""
    names = _names(mesh)
    if policy in ("dp", "fsdp") or policy is True:
        return tuple(a for a in ("pod", "data", "model") if a in names)
    return ("pod", "data") if "pod" in names else ("data",)


def fit_batch_axes(mesh, batch: int, policy: str = "2d"
                   ) -> Tuple[str, ...]:
    """Longest prefix of the DP axes whose product divides ``batch``."""
    ba = batch_axes(mesh, policy)
    while ba:
        if batch % axes_size(mesh, ba) == 0:
            return ba
        ba = ba[:-1]
    return ()


def rows_of(mesh, batch: int, policy: str = "2d") -> Tuple[int, int]:
    """[lo, hi) of a (batch, ...) input's rows this rank holds under
    ``data_spec`` (every row when the batch is not cut)."""
    ba = fit_batch_axes(mesh, batch, policy)
    k = batch // axes_size(mesh, ba)
    i = mesh.index(ba) if ba else 0
    return i * k, (i + 1) * k


def spec_part(axes: Tuple[str, ...]):
    """A tuple of mesh axes as one spec entry (None, a name, or the
    tuple)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def data_spec(mesh, batch: int, *trailing: Optional[str],
              policy: str = "2d") -> Spec:
    """Spec of a (batch, ...) input: batch over the largest feasible
    DP-axis prefix, else replicated."""
    return (spec_part(fit_batch_axes(mesh, batch, policy)),) + tuple(trailing)


def cache_spec(mesh, batch: int, seq: int) -> Tuple[Any, Any]:
    """(batch_part, seq_part) of a KV cache: batch over the DP axes if
    they divide it, else the sequence over "data" (long context, batch
    1), else replicated."""
    ba = batch_axes(mesh)
    if batch % axes_size(mesh, ba) == 0:
        return spec_part(ba), None
    if seq % int(mesh.shape["data"]) == 0:
        return None, "data"
    return None, None


def cache_leaf_spec(shape: Sequence[int], batch: int, max_seq: int, mesh,
                    policy: str = "2d") -> Spec:
    """JAX's ``cache_shardings`` of one cache leaf (stack dims included),
    which finds its dims by length: the batch dim is the first of length
    ``batch`` (over the DP axes that divide it), the sequence dim the last
    later one of length ``max_seq``: over "model" under "2d" when "model"
    divides it, else over "data" when the batch is not cut and "data"
    divides it (the long-context layout); a leaf with no sequence dim (a
    recurrent state) is cut over "model" on its last trailing dim that
    "model" divides."""
    ba = fit_batch_axes(mesh, batch, policy)
    nmodel = int(mesh.shape.get("model", 1)) if policy == "2d" else 1
    batch_part = spec_part(ba)
    parts: list = [None] * len(shape)
    b_idx = seq_idx = None
    for i, d in enumerate(shape):
        if b_idx is None and d == batch:
            b_idx = i
        elif d == max_seq and i > (b_idx if b_idx is not None else -1):
            seq_idx = i
    if b_idx is not None and batch_part is not None:
        parts[b_idx] = batch_part
    if seq_idx is not None and nmodel > 1 and max_seq % nmodel == 0:
        parts[seq_idx] = "model"
    elif (seq_idx is not None and batch_part is None
          and max_seq % int(mesh.shape["data"]) == 0):
        parts[seq_idx] = "data"
    elif seq_idx is None and nmodel > 1:
        for i in range(len(shape) - 1, b_idx if b_idx is not None else -1,
                       -1):
            if (parts[i] is None and shape[i] % nmodel == 0
                    and shape[i] >= nmodel):
                parts[i] = "model"
                break
    return tuple(parts)


def effective(spec: Spec, mesh) -> Spec:
    """``spec`` with the entries whose axes have one rank dropped (two
    specs with equal effective forms give every rank the same piece)."""
    return tuple(e if axes_size(mesh, e) > 1 else None for e in spec)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_leaves(specs: Any) -> list:
    """The leaves (spec tuples) of a dict tree of specs, in sorted-key
    order (``optimizer.tree_leaves``' order of the parameters)."""
    if isinstance(specs, tuple):
        return [specs]
    return [x for k in sorted(specs) for x in spec_leaves(specs[k])]


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's piece of a tensor of ``shape``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(n) // axes_size(mesh, e) for n, e in zip(shape, spec))


def local_slice(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's piece of a whole tensor (a view; ``x`` itself when no
    dim is cut)."""
    for dim, e in enumerate(spec):
        n = axes_size(mesh, e)
        if n > 1:
            k = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(spec_axes(e)) * k, k)
    return x


def param_placements(spec: Spec, mesh) -> list:
    """DTensor placements of a tensor with ``spec``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` it cuts, else ``Replicate()``
    (a tuple entry cuts one dim over several mesh dims, outer first, as
    DTensor reads a dim sharded twice)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for a in _names(mesh):
        dims = [d for d, e in enumerate(spec) if a in spec_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def constrain(x: torch.Tensor, spec: Spec, mesh,
              global_shape: Sequence[int]) -> torch.Tensor:
    """``x`` itself, checked to be this rank's piece of a tensor of
    ``global_shape`` laid out by ``spec`` (JAX's
    ``with_sharding_constraint``: the port cannot move data by
    annotation, so a layout that disagrees is an error).  Unsharded: the
    whole shape."""
    want = (tuple(global_shape) if mesh is None
            else local_shape(global_shape, spec, mesh))
    if tuple(x.shape) != want:
        raise ValueError(f"expected this rank's piece {want} of "
                         f"{tuple(global_shape)} under {spec}, got "
                         f"{tuple(x.shape)}")
    return x
