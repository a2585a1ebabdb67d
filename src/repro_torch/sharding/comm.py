"""The LM mesh's collectives, differentiable where training needs them.

The JAX package lets GSPMD place the collectives its specs imply; the
port issues them itself, one process per card:

  * ``gather_dim`` / ``_Gather``: an FSDP all-gather of a weight shard
    along one dim, whose backward reduce-scatters (sums) the gradient
    over the same ranks;
  * ``copy_to_model`` and ``reduce_from_model``: Megatron's f/g pair
    around a tensor-parallel region.  f is the identity forward and sums
    the gradient over "model" backward (at the input of column-parallel
    products, which every model rank reads); g sums over "model" forward
    (after a row-parallel product, or a vocab-parallel lookup or
    reduction) and passes the gradient through backward;
  * ``all_gather`` / ``all_reduce`` / ``all_max``: the same collectives
    without autograd (decode, metrics, the optimizer's norm);
  * the collectives of JAX's ``shard_map`` bodies (the MoE's expert
    parallelism), with the transposes ``shard_map`` gives them:
    ``psum`` (a sum both ways), ``pmean`` (a mean both ways),
    ``grad_mean`` (the identity, the gradient's mean), ``scatter_sum``
    (a reduce-scatter; backward all-gathers), ``count_sum`` (a sum of a
    count, no gradient) and ``first_rank`` (an ``out_specs`` ``P()``
    output that differs over ranks: the value JAX reads back, the first
    rank's, and the gradient over the ranks the spec leaves out).

No group (None: ``LMMesh.group`` along an axis of one rank) issues
nothing and returns the input, so the one-rank mesh runs the unsharded
ops exactly.  A real group of one rank (``make_host_mesh(
one_rank_groups=True)``) issues every collective, which then copies.
Lists go to ``dist.all_gather`` / ``dist.reduce_scatter`` (gloo on the
CPU and NCCL on the card take both).
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks of ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    if group is None:
        return x
    n = group_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts[0] if n == 1 else torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, cut along ``dim``: this rank's
    piece."""
    if group is None:
        return x
    n = group_size(group)
    parts: List[torch.Tensor] = [c.contiguous() for c in x.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group (a new tensor; ``x`` is left alone)."""
    if group is None:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, dist.ReduceOp.MAX, group=group)
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group) / group_size(ctx.group), None


class _GradMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group) / group_size(ctx.group), None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _FirstRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        return all_gather(x.reshape(1, *x.shape), 0, group)[0]

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``psum`` inside ``shard_map``: the sum over the group, whose
    transpose is the sum of the gradient over it too."""
    if group is None:
        return x
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``pmean``: the mean over the group both ways."""
    if group is None:
        return x
    return _Pmean.apply(x, group)


def grad_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; backward the mean of the gradient over the group
    (an input every rank of the group holds, whose gradient each rank
    holds a share of)."""
    if group is None:
        return x
    return _GradMean.apply(x, group)


def scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group cut along ``dim``, this rank's piece;
    backward all-gathers the gradient."""
    if group is None:
        return x
    return _ScatterSum.apply(x, dim, group)


def count_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of a count over the group (no gradient)."""
    return all_reduce(x.detach(), group)


def first_rank(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """A ``shard_map`` output of ``out_specs`` ``P()`` whose value differs
    over ``group``: forward the value of the group's first rank (the
    device JAX reads a replicated array from), backward the gradient over
    ``n``, the ranks of the mesh the spec leaves out (``shard_map``'s
    transpose divides by them)."""
    if group is None and n == 1:
        return x
    return _FirstRank.apply(x, group, n)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` (backward: reduce-scatter)."""
    if group is None:
        return x
    return _Gather.apply(x, dim, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity; backward sums the gradient over the group."""
    if group is None:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over the group; backward passes through."""
    if group is None:
        return x
    return _ReduceFromModel.apply(x, group)


def whole(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's piece of a tensor laid out by ``spec`` -> the whole
    tensor (every cut dim all-gathered over its axes; no gradient)."""
    from repro_torch.sharding.rules import spec_axes
    for dim, e in enumerate(spec):
        axes = spec_axes(e)
        if axes and mesh.size(axes) > 1:
            x = all_gather(x, dim, mesh.group(axes))
    return x
