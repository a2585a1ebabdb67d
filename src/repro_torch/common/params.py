"""Parameter declarations and seeded initialisation.

A module declares its parameters as a (nested) dict of :class:`ParamDef`
(shape + initializer + storage dtype).  Two initialisers turn it into
tensors:

* ``init_params`` makes the same draws the JAX package's
  ``repro.common.params.init_params`` makes for a flat dict: leaves in
  sorted-key order (``jax.tree.flatten`` of a dict), one ``split`` key per
  leaf, threefry normals.  The detector and utility MLP use it, so their
  weights equal JAX's bit for bit.
* ``init_params_generator`` draws from a ``torch.Generator`` on the
  generator's device, one leaf at a time and a slab of the leading (layer)
  axis at a time, so a model at full width initialises on the card with
  temporaries of one layer's matrix.  Its numbers differ from
  ``jax.random``'s; parity with JAX goes through converted weights
  (``common/convert.py``).

Both follow the JAX rules: ``normal`` is a fan-in scaled normal whose
fan-in is the product of every axis but the last (for a stacked
``(layers, d_in, d_out)`` matrix that includes the layer axis, as in
JAX), ``embed`` a normal of std ``0.02 * scale``, ``zeros`` and ``ones``
constants; each is drawn in float32 and stored in the leaf's dtype.

Each ParamDef carries the JAX declaration's ``logical_axes`` (one name
per dim: ``"embed"``, ``"mlp"``, ``"heads"``, ``"vocab"``, ``"layers"``,
...), from which ``sharding.rules.param_pspecs`` derives a layout on a
mesh; ``map_defs`` and the initialisers carry it through.

``abstract_params`` is the counterpart of JAX's allocation-free
``ShapeDtypeStruct`` tree: the same nest of tensors on
``torch.device("meta")``, which hold a shape and a dtype and no memory
(the one-card dry run, ``launch/dryrun.py``, sums their bytes).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import prng


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | embed
    scale: float = 1.0        # multiplier on the default scale
    dtype: torch.dtype = torch.float32   # storage dtype
    # one logical axis name (or None) per dim, as the JAX ParamDef's;
    # ``sharding.rules`` maps them to mesh axes.  Empty: no layout
    # declared (the detector and the utility MLP)
    logical_axes: Tuple[Optional[str], ...] = ()


def _std(d: ParamDef) -> float:
    if d.init == "embed":
        return 0.02 * d.scale
    if d.init != "normal":
        raise ValueError(f"unknown initializer {d.init!r}")
    # fan-in: rows of a matrix, k*k*cin of an HWIO conv, size of a vector
    fan_in = (int(np.prod(d.shape[:-1])) if len(d.shape) >= 2
              else max(int(np.prod(d.shape)), 1))
    return float(np.float32(d.scale / np.sqrt(max(fan_in, 1))))


def _init_leaf(key: torch.Tensor, d: ParamDef) -> torch.Tensor:
    if d.init in ("zeros", "ones"):
        fill = torch.zeros if d.init == "zeros" else torch.ones
        return fill(d.shape, dtype=d.dtype, device=key.device)
    return (prng.normal(key, d.shape) * _std(d)).to(d.dtype)


def init_params(key: torch.Tensor, defs: Dict[str, ParamDef]
                ) -> Dict[str, torch.Tensor]:
    """Materialise a flat dict of ParamDefs (sorted-key leaf order)."""
    names = sorted(defs)
    keys = prng.split(key, len(names))
    return {n: _init_leaf(keys[i], defs[n]) for i, n in enumerate(names)}


def map_defs(fn, defs: Any) -> Any:
    """Apply ``fn`` to every ParamDef of a nested dict (sorted keys)."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, defs[k]) for k in sorted(defs)}


def abstract_params(defs: Any) -> Any:
    """The tree of ParamDefs as tensors on the meta device: shapes and
    dtypes, nothing allocated."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def param_count(defs: Any) -> int:
    n = []
    map_defs(lambda d: n.append(int(np.prod(d.shape))), defs)
    return sum(n)


def param_bytes(defs: Any) -> int:
    n = []
    map_defs(lambda d: n.append(int(np.prod(d.shape))
                                * torch.empty((), dtype=d.dtype).element_size()),
             defs)
    return sum(n)


def init_params_generator(defs: Any, generator: torch.Generator,
                          keep: Optional[Callable] = None) -> Any:
    """Materialise a nested dict of ParamDefs on ``generator.device``,
    drawing each leaf from ``generator`` in sorted-key order.  ``keep(d,
    t)`` (optional) maps each whole drawn leaf to what is kept of it (a
    rank's shard under a mesh): every rank draws the same numbers, and
    only one whole leaf is alive at a time."""
    dev = generator.device

    def leaf(d: ParamDef) -> torch.Tensor:
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(d.shape, dtype=d.dtype, device=dev)
        std = _std(d)
        out = torch.empty(d.shape, dtype=d.dtype, device=dev)
        # stacked leaves one layer at a time: a float32 draw of a whole
        # (36, 4096, 14336) stack would be 8.5 GB of temporaries
        for slab in (out if out.dim() >= 3 else (out,)):
            slab.copy_(torch.randn(slab.shape, generator=generator,
                                   device=dev, dtype=torch.float32).mul_(std))
        return out

    if keep is None:
        return map_defs(leaf, defs)
    return map_defs(lambda d: keep(d, leaf(d)), defs)
