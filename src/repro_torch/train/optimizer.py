"""AdamW with global-norm clipping and a warmup + cosine schedule.

The counterpart of ``repro.train.optimizer``: plain functions on dicts of
tensors (``{name: tensor}``), every step's arithmetic in float32 tensors
on the parameters' device, so a training loop built on it never reads the
device from the host.  ``torch.optim.AdamW`` is no substitute: it decays
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

The JAX module's ``abstract_opt_state`` has no counterpart: it builds
``ShapeDtypeStruct`` stand-ins for the TPU dry run, which the port does
not have.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.common import prng
from repro_torch.common.config import OptimizerConfig

Params = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor       # int32 0-d
    m: Params                # first moment (params-like)
    v: Params                # second moment (params-like)


def init_opt_state(cfg: OptimizerConfig, params: Params) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m={k: zeros(p) for k, p in params.items()},
                    v={k: zeros(p) for k, p in params.items()})


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


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of the per-leaf sums of squares (sorted keys)."""
    leaves = [torch.sum(torch.square(tree[k].to(torch.float32)))
              for k in sorted(tree)]
    return prng.sqrt(torch.sum(torch.stack(leaves)))


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """1 - b ** step in float32 (the power through float64)."""
    return 1.0 - torch.pow(_f32(b), step.to(torch.float64)).float()


def adamw_update(cfg: OptimizerConfig, params: Params, grads: Params,
                 state: OptState) -> Tuple[Params, OptState,
                                           Dict[str, torch.Tensor]]:
    """One AdamW step.  All math in float32; moments stored in
    ``cfg.moment_dtype``; parameters updated in their storage dtype.
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
    mdt = getattr(torch, cfg.moment_dtype)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        p, g = params[k], grads[k].to(torch.float32) * clip
        m32 = prng.fma(state.m[k].to(torch.float32), b1, g * c1)
        v32 = prng.fma(state.v[k].to(torch.float32), b2,
                       torch.square(g) * c2)
        delta = m32 / (bc1 * (prng.sqrt(v32 / bc2) + _f32(cfg.eps)))
        p32 = p.to(torch.float32)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            delta = prng.fma(p32, _f32(cfg.weight_decay), delta)
        new_p[k] = prng.fma(-lr, delta, p32).to(p.dtype)
        new_m[k] = m32.to(mdt)
        new_v[k] = v32.to(mdt)
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gnorm,
                                                  "lr": lr}
