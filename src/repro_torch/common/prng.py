"""Counter-based threefry2x32 keys and draws, bitwise equal to ``jax.random``.

The JAX package draws every random input on the episode path from
``jax.random`` with the default threefry2x32 implementation and
``jax_threefry_partitionable=True``: scene noise, the per-(slot, camera)
codec keys, the coding noise and the utility-MLP init.  The port must draw
the same bits, so this module re-implements the pieces it uses:

  * ``PRNGKey(seed)``  -> (2,) key ``[seed >> 32, seed & 0xffffffff]``;
  * ``fold_in(key, d)`` -> ``threefry2x32(key, (0, d))``;
  * ``split(key, n)``   -> ``threefry2x32(key, (hi(i), lo(i)))`` for i < n;
  * ``random_bits``     -> ``x1 ^ x2`` of ``threefry2x32(key, (hi(i), lo(i)))``
    over the flat row-major index i (the partitionable counter layout);
  * ``uniform`` / ``normal`` -> JAX's mantissa trick and
    ``sqrt(2) * erf_inv(u)`` with XLA's float32 ``erf_inv`` expansion.

Keys are int64 tensors holding uint32 values (shape (..., 2)); uint32
arithmetic runs in int64 and is masked back to 32 bits.  Every function
takes batched keys: a leading key shape broadcasts over the draw.

``erf_inv`` and ``log1p`` are built from IEEE add, multiply, divide and
correctly rounded sqrt only, so the draws are the same bits on the CPU and
on the card (a library ``log1p`` differs between the two, and
``torch.special.erfinv`` differs from XLA's expansion in most inputs).

``normal`` and ``normal_erfinv`` of CUDA keys are one launch of the
threefry_normal kernel (``kernels/threefry_normal``), which repeats this
module's arithmetic operation by operation; CPU keys take the torch code
here, fake keys the kernel's stand-in.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.common.device import is_fake

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 block function on broadcastable int64 tensors of
    uint32 values (JAX's unrolled lowering, five 4-round groups)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for g in range(5):
        for r in _ROT[g % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(g + 1) % 3]) & MASK
        b = (b + ks[(g + 2) % 3] + (g + 1)) & MASK
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a non-negative 32-bit seed."""
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must be a uint32 value, got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data a Python int or an integer
    tensor that broadcasts against the key's batch shape -> (..., 2).
    Neither form uploads anything: an int enters the arithmetic as a
    scalar, a tensor (a 0-d slot index on the card, say) is used where it
    lies."""
    if torch.is_tensor(data):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
        x1 = torch.zeros_like(d)
    else:
        d, x1 = int(data) & MASK, 0
    a, b = threefry2x32(key[..., 0], key[..., 1], x1, d)
    return torch.stack([a, b], dim=-1)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key (2,) -> (num, 2)."""
    hi, lo = _counters(num, key.device)
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([a, b], dim=-1)


def _shape(shape: Shape):
    return (int(shape),) if isinstance(shape, (int, np.integer)) else \
        tuple(int(s) for s in shape)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit random words: key (..., 2) -> (..., *shape) int64."""
    shape = _shape(shape)
    n = math.prod(shape)
    hi, lo = _counters(n, key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (a ^ b).reshape(key.shape[:-1] + shape)


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under a
    unit exponent, minus one, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo, span = _bounds(minval, maxval)
    return torch.clamp(floats * span + lo, min=lo)


def _bounds(minval: float, maxval: float):
    """``uniform``'s lower bound and span in float32, as kernel arguments
    (nothing is uploaded)."""
    lo = _f32(minval)
    return lo, float(np.float32(maxval) - np.float32(lo))


# XLA's float32 erf_inv (Giles' single-precision polynomial), Horner order
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _f32(x: float) -> float:
    return float(np.float32(x))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64: PyTorch's
    vectorised CPU ``sqrt`` is off by one ulp in about 0.5% of inputs)."""
    return torch.sqrt(x.double()).float()


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: the float64 product of two float32
    values is exact, so one float64 add and one rounding to float32 give
    the fused result (XLA's CPU backend contracts these pairs)."""
    a = a.double()
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


# Cephes' logf polynomial as XLA's CPU backend expands ``log``
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
# Cephes' log1p rational approximation for |x| < sqrt(2) - 1
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log(v: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive normal inputs: exponent split,
    mantissa folded into [sqrt(1/2), sqrt(2)), degree-8 polynomial."""
    v = torch.clamp(v, min=_f32(1.17549435e-38))
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = m * m
    x3 = x2 * m
    y = fma(m, _LOG_P[0], _LOG_P[1])
    y1 = fma(m, _LOG_P[3], _LOG_P[4])
    y2 = fma(m, _LOG_P[6], _LOG_P[7])
    y = fma(y, m, _LOG_P[2])
    y1 = fma(y1, m, _LOG_P[5])
    y2 = fma(y2, m, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    m = fma(x2, -0.5, m)
    return fma(e, _LOG_Q2, m + y)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    r = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        r = fma(r, x, _f32(c))
    return r


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA's CPU backend expands it: a rational
    approximation for |x| < sqrt(2) - 1, ``log(1 + x)`` elsewhere.  Valid
    for x > -1 (all ``erf_inv`` needs)."""
    x2 = x * x
    s = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    s = fma(x2, -0.5, (x * x2) * s)
    small = x.abs() < _f32(0.41421356237309504880)
    return torch.where(small, x + s, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` expansion: w = -log1p(-x*x); a degree-8
    polynomial in (w - 2.5) or (sqrt(w) - 3) with fused Horner steps;
    times x; +-inf at |x| == 1."""
    w = -log1p(x * (-x))
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    # the coefficients enter as scalars (nothing is uploaded)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, ww, torch.where(lt, _f32(c_lt), _f32(c_ge)))
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


SQRT2 = _f32(math.sqrt(2.0))


def normal_erfinv(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``erf_inv(u)`` of ``normal``'s uniform draw: ``normal`` is this times
    ``SQRT2``.  XLA folds a constant scale into the ``SQRT2`` factor
    (``c * normal`` becomes ``(c * SQRT2) * erf_inv(u)``), so callers that
    scale by a constant need the unscaled draw to match it."""
    return _normal(key, shape, scaled=False)


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: key (..., 2) -> (..., *shape)."""
    return _normal(key, shape, scaled=True)


def _normal(key: torch.Tensor, shape: Shape, scaled: bool) -> torch.Tensor:
    """The draw by where the key lies: the torch code above on the CPU, one
    launch of the threefry_normal kernel (the same bits) on the card, its
    stand-in on fake tensors."""
    shape = _shape(shape)
    fake = is_fake(key)
    if not fake and key.device.type != "cuda":
        e = erf_inv(uniform(key, shape, _LO, 1.0))
        return e * SQRT2 if scaled else e
    from repro_torch.kernels.threefry_normal import ops
    if fake:
        return ops.threefry_normal_stand_in(key, shape)
    return ops.threefry_normal_cuda(key.contiguous(), shape,
                                    *_bounds(_LO, 1.0), scaled)
