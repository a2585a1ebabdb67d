"""The threefry normal draw on the card: ``prng.normal`` and
``prng.normal_erfinv`` of CUDA keys as one launch of
``csrc/threefry_normal.cu``, and a stand-in for fake tensors
(``analysis.trace_cost``).  The plain version is ``prng``'s torch code,
which CPU keys take: ``prng._normal`` dispatches, so CPU tensors never
reach this module.

The kernel gives the plain version's bits: the same threefry2x32 counter
layout, mantissa trick and float32 ``erf_inv`` expansion, with ``prng.fma``
and ``prng.sqrt`` through float64 as the plain version computes them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.common.device import record_kernel
from repro_torch.kernels import build

# kernel launches since the last reset
LAUNCHES = 0
# operations a value, fused steps counted as two: the threefry block (2
# whitening adds, 20 rounds of add, rotate and xor, 5 key injections of
# 3 adds) and the xor of its words, 78; the uniform (shift, or, subtract,
# scale, shift, clamp), 6; log1p (either branch), 33; erf_inv's square,
# test, polynomial of 8 fused steps and tails, 23
OPS_PER_VALUE = 140

_LAUNCH = None


def _launcher():
    """The kernel's C entry point, its argument types bound once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = build.library("threefry_normal").threefry_normal_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def cost(num_keys: int, n: int) -> Tuple[int, int]:
    """(operations, bytes) of one draw of ``n`` values under each of
    ``num_keys`` keys: the keys read once (16 bytes each), the values
    written once."""
    return OPS_PER_VALUE * num_keys * n, 16 * num_keys + 4 * num_keys * n


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be (..., 2) int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")


def threefry_normal_cuda(keys: torch.Tensor, shape: Tuple[int, ...],
                         lo: float, span: float, scaled: bool
                         ) -> torch.Tensor:
    """Launch the kernel on the current stream: keys (..., 2) int64 on the
    card, contiguous -> (..., *shape) float32, ``erf_inv`` of the uniform
    on [lo, lo + span), times ``prng.SQRT2`` if ``scaled``."""
    global LAUNCHES
    _check_keys(keys)
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if keys.device.type != "cuda":
        raise ValueError(f"keys must be a CUDA tensor, got {keys.device}")
    out = torch.empty(keys.shape[:-1] + tuple(shape), dtype=torch.float32,
                      device=keys.device)
    if out.data_ptr() % 16:
        raise ValueError("the output must start on a 16-byte boundary")
    err = _launcher()(keys.data_ptr(), out.data_ptr(), keys.numel() // 2,
                      math.prod(shape), lo, span, int(scaled),
                      torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry_normal kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out


def threefry_normal_stand_in(keys: torch.Tensor, shape: Tuple[int, ...]
                             ) -> torch.Tensor:
    """The kernel on fake tensors: the draw at its shape and float32, and
    one launch with its operations and bytes."""
    _check_keys(keys)
    out = torch.empty(keys.shape[:-1] + tuple(shape), dtype=torch.float32,
                      device=keys.device)
    record_kernel("threefry_normal", *cost(keys.numel() // 2,
                                           math.prod(shape)))
    return out
