"""JAX parameter trees (as numpy) -> the port's parameter dicts.

``detector``: convolution kernels go from HWIO (``lax.conv_general_dilated``
layout) to OIHW (``torch.nn.functional.conv2d``); biases stay as they are.
``mlp``: the utility MLP keeps its ``x @ w`` matrices as they are.
Both are flat and come out float32; ``params_to_numpy`` takes a detector
back to the JAX layout (a port-trained detector saves as JAX's does).
``lm``: the LM's nested tree keeps its structure, its stacked layer axis,
its ``(d_in, d_out)`` matrices and each leaf's dtype.  A bfloat16 leaf
arrives as numpy's ``bfloat16`` extension type, which ``torch.from_numpy``
refuses: it goes through float32 and back to bfloat16, which is exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.common.device import resolve_device

_DETECTOR_CONVS = ("c1", "c2", "c3", "c4", "head")


def _lm_leaf(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _lm_tree(tree: Any, device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _lm_tree(v, device) for k, v in tree.items()}
    return _lm_leaf(tree, device)


def params_from_numpy(tree: Mapping[str, Any], kind: str, *,
                      device=None) -> Dict[str, Any]:
    """``{name: array}`` (nested for ``lm``) -> the same names as tensors on
    ``device`` (``resolve_device``: the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    if kind == "lm":
        return _lm_tree(tree, device)
    if kind not in ("detector", "mlp"):
        raise ValueError(f"unknown parameter kind {kind!r}")
    out = {}
    for name, arr in tree.items():
        a = np.asarray(arr, np.float32)
        if kind == "detector" and name in _DETECTOR_CONVS:
            a = np.transpose(a, (3, 2, 0, 1))          # HWIO -> OIHW
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor], kind: str
                    ) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_numpy`` for the detector: float32
    numpy in JAX's layout (kernels OIHW -> HWIO)."""
    if kind != "detector":
        raise ValueError(f"unknown parameter kind {kind!r}")
    out = {}
    for name, t in params.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        if name in _DETECTOR_CONVS:
            a = np.transpose(a, (2, 3, 1, 0))          # OIHW -> HWIO
        out[name] = np.ascontiguousarray(a)
    return out
