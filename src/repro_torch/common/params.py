"""Parameter declarations and seeded initialisation.

A module declares its parameters as a dict of :class:`ParamDef` (shape +
initializer); ``init_params`` turns it into a dict of tensors with the
same draws the JAX package's ``repro.common.params.init_params`` makes:
leaves in sorted-key order (``jax.tree.flatten`` of a dict), one
``split`` key per leaf, fan-in scaled normals.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.common import prng


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros
    scale: float = 1.0        # multiplier on the fan-in scale


def _init_leaf(key: torch.Tensor, d: ParamDef) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=torch.float32, device=key.device)
    if d.init != "normal":
        raise ValueError(f"unknown initializer {d.init!r}")
    # fan-in: rows of a matrix, k*k*cin of an HWIO conv, size of a vector
    fan_in = (int(np.prod(d.shape[:-1])) if len(d.shape) >= 2
              else max(int(np.prod(d.shape)), 1))
    std = np.float32(d.scale / np.sqrt(max(fan_in, 1)))
    return prng.normal(key, d.shape) * float(std)


def init_params(key: torch.Tensor, defs: Dict[str, ParamDef]
                ) -> Dict[str, torch.Tensor]:
    """Materialise a flat dict of ParamDefs (sorted-key leaf order)."""
    names = sorted(defs)
    keys = prng.split(key, len(names))
    return {n: _init_leaf(keys[i], defs[n]) for i, n in enumerate(names)}
