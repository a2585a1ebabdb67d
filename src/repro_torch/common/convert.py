"""JAX parameter trees (as numpy) -> the port's parameter dicts.

``detector``: convolution kernels go from HWIO (``lax.conv_general_dilated``
layout) to OIHW (``torch.nn.functional.conv2d``); biases stay as they are.
``mlp``: the utility MLP keeps its ``x @ w`` matrices as they are.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DETECTOR_CONVS = ("c1", "c2", "c3", "c4", "head")


def params_from_numpy(tree: Mapping[str, np.ndarray], kind: str, *,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Flat ``{name: array}`` -> ``{name: float32 tensor}`` on ``device``."""
    if kind not in ("detector", "mlp"):
        raise ValueError(f"unknown parameter kind {kind!r}")
    out = {}
    for name, arr in tree.items():
        a = np.asarray(arr, np.float32)
        if kind == "detector" and name in _DETECTOR_CONVS:
            a = np.transpose(a, (3, 2, 0, 1))          # HWIO -> OIHW
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
