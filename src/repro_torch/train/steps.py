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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.common.config import RunConfig
from repro_torch.models.model import LM
from repro_torch.train.optimizer import (OptState, Tree, adamw_update,
                                         init_opt_state, tree_leaves,
                                         tree_map)


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
            mbs = _split_microbatches(batch, nmb)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            auxs = []
            for i in range(nmb):
                (l, aux), g = value_and_grad(
                    lm.loss, params, {k: v[i] for k, v in mbs.items()})
                tree_map(lambda a, b: a.add_(b), grads, g)
                loss = loss + l
                auxs.append(aux)
                del g
            tree_map(lambda a: a.div_(nmb), grads)
            loss = loss / nmb
            aux = {k: torch.mean(torch.stack([a[k] for a in auxs]))
                   for k in auxs[0]}
        new_params, new_opt, stats = adamw_update(
            run.opt, params, grads, opt_state, inplace=donate)
        return new_params, new_opt, {"loss": loss, **stats, **aux}

    return train_step


def make_serve_prefill(lm: LM, max_seq: int) -> Callable:
    def serve_prefill(params, batch):
        return lm.prefill(params, batch, max_seq)
    return serve_prefill


def make_serve_decode(lm: LM) -> Callable:
    def serve_decode(params, tokens, cache, pos):
        return lm.decode(params, tokens, cache, pos)
    return serve_decode


def init_train_state(lm: LM, run: RunConfig, generator: torch.Generator
                     ) -> Tuple[Tree, OptState]:
    """Seeded random weights on ``generator.device`` and a zero optimizer
    state."""
    params = lm.init(generator)
    return params, init_opt_state(run.opt, params)
