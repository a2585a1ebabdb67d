"""int8 error-feedback gradient compression for a data-parallel
reduction (``repro.train.compression`` in PyTorch).

Each rank quantizes its gradient plus its carried residual with one
per-tensor scale (``max |x| / 127``), the int8 values are summed over the
group in int32 (one all-reduce) and the scales reduced with MAX (one
more); the mean is ``total * smax / n``, exactly as JAX computes it,
although each rank's scale differs and the sum is of values quantized
with their own scales.  The quantization error is the next step's
residual (error feedback).  ``wire_bytes`` gives the (uncompressed,
compressed) bytes a step sends.

JAX's ``OptimizerConfig.compress_grads`` names this path for the
backbone trainer but no trainer reads it, and the port's does not
either: ``train.steps.sync_grads`` reduces gradients uncompressed.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.sharding import comm
from repro_torch.train.optimizer import tree_leaves, tree_map

F32 = torch.float32


def init_residuals(params: Any) -> Any:
    """Zero float32 residuals in the parameters' structure."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, the float32 scale) of x: rounded half to even,
    clipped to [-127, 127]."""
    scale = torch.amax(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _one(g: torch.Tensor, r: torch.Tensor, group
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = comm.group_size(group)
    x = g.to(F32) + r
    q, scale = _quantize(x)
    err = x - q.to(F32) * scale
    total = comm.all_reduce(q.to(torch.int32), group)
    # the scales differ per rank: their max bounds every rank's values
    smax = scale if group is None else comm.all_max(scale, group)
    return total.to(F32) * smax / n, err


def compressed_psum(grads: Any, residuals: Any, group
                    ) -> Tuple[Any, Any]:
    """All-reduce-mean ``grads`` over ``group`` (None: one rank, no
    collective) with int8 error feedback.  ``grads`` and ``residuals``
    are this rank's trees of whole-shaped tensors.  Returns (the mean
    gradients, this rank's new residuals)."""
    out = tree_map(lambda g, r: _one(g, r, group), grads, residuals)

    def pick(t, i):
        return t[i] if isinstance(t, tuple) else {k: pick(v, i)
                                                   for k, v in t.items()}
    return pick(out, 0), pick(out, 1)


def wire_bytes(params: Any, dtype_bytes: int = 4) -> Tuple[int, int]:
    """(uncompressed, compressed) per-step data-parallel bytes: the int8
    payload (the scales are negligible)."""
    n = sum(int(p.numel()) for p in tree_leaves(params))
    return n * dtype_bytes, n

