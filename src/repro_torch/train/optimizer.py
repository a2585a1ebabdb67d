"""AdamW with global-norm clipping and a warmup + cosine schedule.

The counterpart of ``repro.train.optimizer``: plain functions on trees of
tensors (a tensor, or a dict of trees: the detector's and the utility
MLP's flat ``{name: tensor}``, the LM's nested dict), every step's
arithmetic in float32 tensors on the parameters' device, so a training
loop built on it never reads the device from the host.  Leaves are
visited in ``jax.tree.leaves`` order (sorted keys, recursively).  ``torch.optim.AdamW`` is no substitute: it decays
every parameter, where this decays only matrices (``p.ndim >= 2``), and it
rounds in another order.

Numerics follow XLA's CPU program for the JAX module, so that a step on
the CPU agrees with it to the last bit or two: the schedule, the bias
corrections ``b ** step`` and the clip factor are float32 tensors, never
Python floats (float64); a division by a constant is a product with its
float32 reciprocal (XLA's rewrite); ``mhat / (sqrt(vhat) + eps)`` is
``m / (bc1 * (sqrt(v / bc2) + eps))``; the moment updates, the decay and
the parameter step are the fused multiply-adds XLA forms (``prng.fma``);
``global_norm`` stacks the per-leaf sums of squares (leaves in sorted key
order, the order of ``jax.tree.leaves`` on a dict) and then sums them; the
square root is the correctly rounded ``prng.sqrt``, ``cos`` and ``pow``
go through float64.

The update runs one slab of a leaf at a time (``_slabs``: at most
``SLAB`` elements along the leading axis, one layer of a stacked LM
matrix), so the float64 temporaries of ``prng.fma``/``prng.sqrt`` stay
at one slab's size: a whole (8, 4096, 14336) stack would need 3.8 GB per
float64 temporary.  Every element sees the same arithmetic as an update
of the whole leaf.  ``inplace=True`` writes the new parameters and
moments into the tensors passed in (the JAX launcher's
``donate_argnums``), so a step holds one copy of the training state.

``abstract_opt_state`` is the state of ``init_opt_state`` on the meta
device (shapes and dtypes, nothing allocated), for the one-card dry run
(``launch/dryrun.py``), as JAX's builds ``ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.common import prng
from repro_torch.common.config import OptimizerConfig

Tree = Any               # a tensor, or a dict of trees
SLAB = 1 << 26           # elements per slab of one update


class OptState(NamedTuple):
    step: torch.Tensor       # int32 0-d
    m: Tree                  # first moment (params-like)
    v: Tree                  # second moment (params-like)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree.leaves`` order (sorted keys, recursively)."""
    if torch.is_tensor(tree):
        return [tree]
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``,
    in the same structure."""
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}


def init_opt_state(cfg: OptimizerConfig, params: Tree) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def abstract_opt_state(cfg: OptimizerConfig, params_abs: Tree) -> OptState:
    """``init_opt_state``'s shapes and dtypes on the meta device."""
    dt = getattr(torch, cfg.moment_dtype)
    meta = lambda p: torch.empty(p.shape, dtype=dt,  # noqa: E731
                                 device="meta")
    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    m=tree_map(meta, params_abs), v=tree_map(meta, params_abs))


def _f32(x: float) -> float:
    """A Python float rounded to float32, as XLA holds its constants."""
    return float(torch.tensor(x, dtype=torch.float32))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine to
    0 at ``total_steps``; ``step`` a 0-d integer tensor -> f32 0-d."""
    step = step.to(torch.float32)
    warm = (step + 1.0) * _f32(_f32(cfg.lr)
                               * _f32(1.0 / max(cfg.warmup_steps, 1)))
    t = torch.clamp((step - float(cfg.warmup_steps))
                    * _f32(1.0 / max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = torch.cos((t * _f32(math.pi)).double()).float()
    return torch.where(step < cfg.warmup_steps, warm,
                       (cos + 1.0) * _f32(0.5 * cfg.lr))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of the per-leaf sums of squares (leaf order)."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_leaves(tree)]
    return prng.sqrt(torch.sum(torch.stack(sums)))


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """1 - b ** step in float32 (the power through float64)."""
    return 1.0 - torch.pow(_f32(b), step.to(torch.float64)).float()


def _slabs(t: torch.Tensor) -> list:
    """Indices of ``t`` in slabs of at most ``SLAB`` elements along its
    leading axis (the whole tensor when it is that small)."""
    if t.numel() <= SLAB or t.dim() == 0:
        return [...]
    rows = max(1, SLAB // (t.numel() // t.shape[0]))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def adamw_update(cfg: OptimizerConfig, params: Tree, grads: Tree,
                 state: OptState, *, inplace: bool = False
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  All math in float32; moments stored in
    ``cfg.moment_dtype``; parameters updated in their storage dtype.
    ``inplace`` writes the new parameters and moments into ``params`` and
    ``state`` and returns those same trees.
    Returns (params, state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, state.step)
    bc1 = _bias_correction(cfg.b1, step)
    bc2 = _bias_correction(cfg.b2, step)
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    c1, c2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    eps, wd = _f32(cfg.eps), _f32(cfg.weight_decay)
    mdt = getattr(torch, cfg.moment_dtype)

    def leaf(p, g, m, v):
        out = (p, m, v) if inplace else (
            torch.empty_like(p), torch.empty(p.shape, dtype=mdt,
                                             device=p.device),
            torch.empty(p.shape, dtype=mdt, device=p.device))
        for s in _slabs(p):
            gs = g[s].to(torch.float32) * clip
            m32 = prng.fma(m[s].to(torch.float32), b1, gs * c1)
            v32 = prng.fma(v[s].to(torch.float32), b2,
                           torch.square(gs) * c2)
            delta = m32 / (bc1 * (prng.sqrt(v32 / bc2) + eps))
            p32 = p[s].to(torch.float32)
            if p.dim() >= 2:   # decoupled weight decay on matrices only
                delta = prng.fma(p32, wd, delta)
            out[0][s] = prng.fma(-lr, delta, p32)
            out[1][s] = m32
            out[2][s] = v32
        return out

    new = tree_map(leaf, params, grads, state.m, state.v)
    stats = {"grad_norm": gnorm, "lr": lr}
    if inplace:
        return params, OptState(step, state.m, state.v), stats
    return _pick(new, 0), OptState(step, _pick(new, 1), _pick(new, 2)), stats


def _pick(tree, i: int) -> Tree:
    """Item ``i`` of every (p, m, v) leaf tuple of ``tree``."""
    if isinstance(tree, tuple):
        return tree[i]
    return {k: _pick(v, i) for k, v in tree.items()}
