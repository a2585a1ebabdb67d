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
  * the LM's ("data", "model") or ("pod", "data", "model") meshes
    (``LMMesh``): ``make_host_mesh`` (one rank, (1, 1)),
    ``make_production_mesh`` (the whole world: "model" over the ranks of
    one node by default, "data" over the nodes; with ``multi_pod`` one
    pod per node) and ``lm_device_mesh`` for an explicit shape;
  * ``fake_world`` starts one rank of a world of any size on a "fake"
    process group (no peers, no card), for the traced dry run;
  * ``shutdown`` drops the sharded episode graphs and the LM meshes,
    which hold the group's communicators, and leaves the group.

JAX's production mesh is a fixed 16 x 16 (2 x 16 x 16 multi-pod) of TPU
chips.  That shape has no meaning on a node of 8 cards, so the port's
follows the world it is started in (``torchrun --nnodes N
--nproc-per-node M``): model = M by default (tensor parallelism inside a
node, over NVLink), data = N.
"""
from __future__ import annotations

import os
import itertools
import math
from typing import Dict, Optional, Tuple

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
    holds this group's communicator) and the LM meshes made here (and
    their groups), and leave the process group (if any)."""
    from repro_torch.core.fleet import drop_mesh_graphs
    drop_mesh_graphs()
    _LM_MESHES.clear()
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


# -- the LM's meshes -----------------------------------------------------------

_LM_MESHES: Dict[Tuple, "LMMesh"] = {}


class LMMesh:
    """A ("data", "model") or ("pod", "data", "model") mesh over every
    rank of the default group: rank = row-major over the axes, as
    ``init_device_mesh`` lays it out.  ``axis_names`` and ``shape`` (a
    dict of sizes) are what ``sharding.rules`` reads; ``device_mesh`` is
    the ``DeviceMesh`` (for DTensor placements); ``group(axes)`` is the
    process group along one axis or along several at once (ranks in
    row-major order over them, the order a ``("pod", "data")`` spec
    entry cuts a dim in), None along axes of size 1 (nothing to
    communicate) unless ``one_rank_groups``, which makes a group there
    too, so that every collective of the LM runs (a copy).  Every group
    is made when the mesh is, on every rank in the same order."""

    def __init__(self, shape: Dict[str, int], one_rank_groups: bool = False):
        from torch.distributed.device_mesh import init_device_mesh
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        world = dist.get_world_size()
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"mesh {self.shape} does not cover the "
                             f"{world} ranks of the group")
        self.rank = dist.get_rank()
        self.device_type = group_device_type()
        self.device_mesh = init_device_mesh(
            self.device_type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        sizes = [self.shape[a] for a in self.axis_names]
        coords = list(itertools.product(*[range(n) for n in sizes]))
        self._all_coords = [dict(zip(self.axis_names, c)) for c in coords]
        self.coords = self._all_coords[self.rank]
        self._groups: Dict[Tuple[str, ...], object] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if self.size(axes) == 1 and not one_rank_groups:
                    continue
                # one group per setting of the other axes, all made here
                others = [a for a in self.axis_names if a not in axes]
                for fixed in itertools.product(
                        *[range(self.shape[a]) for a in others]):
                    ranks = [r for r, c in enumerate(coords) if all(
                        c[self.axis_names.index(a)] == v
                        for a, v in zip(others, fixed))]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def _axes(self, axes) -> Tuple[str, ...]:
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes=None) -> int:
        """Ranks along ``axes`` (every axis when None)."""
        axes = self.axis_names if axes is None else self._axes(axes)
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def index(self, axes, rank: Optional[int] = None) -> int:
        """The row-major position along ``axes`` of this rank (or of
        ``rank``)."""
        c = self.coords if rank is None else self._all_coords[rank]
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes):
        """The process group along ``axes`` (None when it has one rank)."""
        axes = self._axes(axes)
        return self._groups.get(axes) if axes else None

    def __repr__(self) -> str:
        return (f"LMMesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}"
                f", rank {self.rank})")


def lm_device_mesh(data: int, model: int, pod: Optional[int] = None, *,
                   one_rank_groups: bool = False) -> LMMesh:
    """The LM mesh of an explicit shape over the default group (which
    must be up): ("data", "model"), or ("pod", "data", "model") with
    ``pod``; ``one_rank_groups`` as ``LMMesh``.  One mesh per shape and
    group is kept (``shutdown`` drops them)."""
    shape = ({"pod": pod} if pod is not None else {}) | {
        "data": data, "model": model}
    key = (tuple(shape.items()), one_rank_groups, dist.get_world_size(),
           dist.get_rank())
    if key not in _LM_MESHES:
        _LM_MESHES[key] = LMMesh(shape, one_rank_groups)
    return _LM_MESHES[key]


def make_host_mesh(device_type: Optional[str] = None, *,
                   one_rank_groups: bool = False) -> LMMesh:
    """The (1, 1) ("data", "model") mesh of a one-rank group, made in this
    process when none is up (JAX's single-device mesh of smoke runs).
    With ``one_rank_groups`` each axis has its one-rank group, so the LM
    on it runs its tensor-parallel path at n = 1 and issues every
    collective (one rank's NCCL ops on the card)."""
    if not dist.is_initialized():
        init_distributed(device_type, rank=0, world_size=1)
    if dist.get_world_size() != 1:
        raise ValueError("make_host_mesh is the mesh of a one-rank group; "
                         "use make_production_mesh under torchrun")
    return lm_device_mesh(1, 1, one_rank_groups=one_rank_groups)


def fake_world(shape: Tuple[int, ...], rank: int = 0) -> LMMesh:
    """Rank ``rank`` of a world of ``prod(shape)`` ranks on a ``"fake"``
    process group (``torch.testing._internal.distributed.fake_pg``:
    every collective returns at once and moves nothing), and the LM mesh
    of ``shape`` on it: ("data", "model") or ("pod", "data", "model").
    What ``analysis.trace_cost`` traces one rank of JAX's production
    mesh on, on a host with no card and no peers: the group touches no
    device (``group_device_type`` is ``"cpu"`` for it).  No group may be
    up; ``shutdown`` ends it."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        raise RuntimeError("a process group is up already; a fake world "
                           "needs a process of its own")
    dist.init_process_group("fake", rank=rank, world_size=math.prod(shape),
                            store=dist.HashStore())
    return lm_device_mesh(*shape[-2:],
                          pod=shape[0] if len(shape) == 3 else None)


def make_production_mesh(*, multi_pod: bool = False,
                         model: Optional[int] = None) -> LMMesh:
    """The LM mesh over the whole world (the group must be up): "model"
    over ``model`` ranks (default: the ranks of one node,
    ``LOCAL_WORLD_SIZE``), "data" over the rest; with ``multi_pod``, one
    pod per node and ("pod", "data", "model") inside it."""
    world = dist.get_world_size()
    local = _env_int("LOCAL_WORLD_SIZE", world)
    model = local if model is None else model
    if multi_pod:
        if world % local or local % model:
            raise ValueError(f"{world} ranks in nodes of {local} do not "
                             f"split into pods of (data, {model})")
        return lm_device_mesh(local // model, model, pod=world // local)
    if world % model:
        raise ValueError(f"model axis {model} does not divide the "
                         f"{world} ranks")
    return lm_device_mesh(world // model, model)
