"""Train and serve steps (``repro.train.steps`` in PyTorch).

``make_train_step``: the loss and its gradients by autograd, microbatched
gradient accumulation into float32 accumulators when ``run.microbatches >
1``, then the port's AdamW (``train/optimizer.py``) and the metrics.  A
step reads nothing back from the device: its metrics are tensors, and
the caller decides when to wait for them.  ``donate=True`` updates the
parameters and optimizer state in place (JAX's ``donate_argnums`` in the
launcher), so a step holds one copy of the training state.
``make_serve_prefill`` / ``make_serve_decode``: the two serving entry
points.

On the LM mesh (``LM(cfg, mesh)``) the parameters, optimizer state and
batch are this rank's pieces and rows.  Each rank's backward holds its
rows' share of the gradient; the leaves' FSDP gathers have reduce-scattered
their cuts already, and ``sync_grads`` sums each leaf over the
data-parallel axes it is not cut over (a replicated leaf over all of
them), once per step after the microbatches.  AdamW then runs on each
rank's pieces with the whole model's norm (``optimizer.global_norm``).
The microbatches are JAX's: blocks of contiguous rows of the global
batch, each laid out over the data-parallel axes as the batch is
(``_microbatch_rows``), so a loss that is not a sum over rows (the MoE's
load-balance term) sees the same rows together.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.config import RunConfig
from repro_torch.models.model import LM
from repro_torch.sharding import comm
from repro_torch.train.optimizer import (OptState, Tree, adamw_update,
                                         global_norm, init_opt_state,
                                         tree_leaves, tree_map)


def _detached(out: Any) -> Any:
    if torch.is_tensor(out):
        return out.detach()
    if isinstance(out, tuple):
        return tuple(_detached(o) for o in out)
    if isinstance(out, dict):
        return {k: _detached(v) for k, v in out.items()}
    return out


def value_and_grad(fn: Callable, params: Tree, *args) -> Tuple[Any, Tree]:
    """``jax.value_and_grad(fn)`` (``has_aux`` when ``fn`` returns a tuple
    whose first item is the loss): (fn's output, gradients of the loss in
    the parameters' structure and dtype)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    out = fn(leaves, *args)
    loss = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return _detached(out), _unflatten(params, list(grads))


def _unflatten(like: Tree, leaves: list) -> Tree:
    """``leaves`` (in ``tree_leaves`` order, consumed) in the structure of
    ``like``."""
    if torch.is_tensor(like):
        return leaves.pop(0)
    return {k: _unflatten(like[k], leaves) for k in sorted(like)}


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int
                        ) -> Dict[str, torch.Tensor]:
    def sp(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} not divisible by {n} "
                             "microbatches")
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    return {k: sp(v) for k, v in batch.items()}


def _microbatch_rows(lm: LM, batch: Dict[str, torch.Tensor], n: int
                     ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each of JAX's ``n`` microbatches, in order:
    the batch (this rank's rows of the whole) gathered over the
    data-parallel axes, and of each block of ``B / n`` rows the rows
    ``batch_rows`` gives this rank."""
    b = next(iter(batch.values())).shape[0]
    B = b * lm.n_dp
    if B % n:
        raise ValueError(f"batch {B} not divisible by {n} microbatches")
    mb = B // n
    lo, hi = lm.batch_rows(mb)

    def rows(x: torch.Tensor) -> torch.Tensor:
        whole = lm.gather_rows(x, B)
        return torch.cat([whole[i * mb + lo:i * mb + hi] for i in range(n)])
    return {k: rows(v) for k, v in batch.items()}


def sync_grads(lm: LM, grads: Tree) -> Tree:
    """Each leaf's gradient summed over the data-parallel axes its FSDP
    gather did not reduce-scatter it over (in place; ``grads`` itself
    unsharded)."""
    if lm.mesh is None:
        return grads

    def one(g: torch.Tensor, spec) -> torch.Tensor:
        rest = tuple(a for a in lm.dp_axes
                     if a not in lm.gathered_axes(spec))
        if lm.mesh.size(rest) > 1:
            g.copy_(comm.all_reduce(g, lm.mesh.group(rest)))
        return g

    def walk(g, spec):
        if torch.is_tensor(g):
            return one(g, spec)
        return {k: walk(g[k], spec[k]) for k in g}
    return walk(grads, lm.specs)


def make_train_step(lm: LM, run: RunConfig, donate: bool = False
                    ) -> Callable:
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): ``loss``, ``grad_norm``, ``lr`` and the loss's aux (``ce``).
    One microbatch: gradients in the parameters' dtype.  Several: float32
    accumulators, gradients / n, loss / n, each aux the mean over the
    microbatches."""
    nmb = run.microbatches

    def train_step(params, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]):
        if nmb == 1:
            (loss, aux), grads = value_and_grad(lm.loss, params, batch)
        else:
            glob = None
            if lm.n_dp > 1:
                glob = next(iter(batch.values())).shape[0] * lm.n_dp // nmb
                batch = _microbatch_rows(lm, batch, nmb)
            mbs = _split_microbatches(batch, nmb)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            auxs = []
            for i in range(nmb):
                (l, aux), g = value_and_grad(
                    lm.loss, params, {k: v[i] for k, v in mbs.items()}, glob)
                tree_map(lambda a, b: a.add_(b), grads, g)
                loss = loss + l
                auxs.append(aux)
                del g
            tree_map(lambda a: a.div_(nmb), grads)
            loss = loss / nmb
            aux = {k: torch.mean(torch.stack([a[k] for a in auxs]))
                   for k in auxs[0]}
        gnorm = None
        if lm.mesh is not None:
            grads = sync_grads(lm, grads)
            gnorm = global_norm(grads, lm.specs, lm.mesh)
        new_params, new_opt, stats = adamw_update(
            run.opt, params, grads, opt_state, inplace=donate,
            grad_norm=gnorm)
        return new_params, new_opt, {"loss": loss, **stats, **aux}

    return train_step


def make_serve_prefill(lm: LM, max_seq: int,
                       global_batch: Optional[int] = None) -> Callable:
    """``global_batch`` as ``LM.prefill``'s (a batch the data-parallel
    ranks do not divide)."""
    def serve_prefill(params, batch):
        return lm.prefill(params, batch, max_seq, global_batch=global_batch)
    return serve_prefill


def make_serve_decode(lm: LM, global_batch: Optional[int] = None
                      ) -> Callable:
    def serve_decode(params, tokens, cache, pos):
        return lm.decode(params, tokens, cache, pos,
                         global_batch=global_batch)
    return serve_decode


def init_train_state(lm: LM, run: RunConfig, generator: torch.Generator
                     ) -> Tuple[Tree, OptState]:
    """Seeded random weights on ``generator.device`` and a zero optimizer
    state."""
    params = lm.init(generator)
    return params, init_opt_state(run.opt, params)
