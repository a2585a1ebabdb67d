"""Knapsack DP dispatch: the plain versions for CPU tensors, the CUDA
kernels (``csrc/knapsack_dp.cu``) for CUDA tensors, nothing else; plus the
static capacity bucket, the device solve (sweep + bounded backtrack: one
launch on the card) and the host solve (the same launch, then a fetch of
the picks and the total; on the CPU the plain sweep and a numpy
backtrack)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.knapsack_dp import ref

# kernel launches since the last reset (sweeps and solves alike)
LAUNCHES = 0

# shared memory one block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448
WARP_MAX = 256       # the widest row (W+1) the one-warp sweep takes

_FNS = None


def _fns():
    """The source's C entry points (sweep, solve, shared-memory size), their
    argument types bound once."""
    global _FNS
    if _FNS is None:
        lib = build.library("knapsack_dp")
        sweep = lib.knapsack_dp_launch
        sweep.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        sweep.restype = ctypes.c_int
        solve_fn = lib.knapsack_dp_solve_launch
        solve_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
            ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        solve_fn.restype = ctypes.c_int
        smem = lib.knapsack_dp_smem
        smem.argtypes = [ctypes.c_int] * 4
        smem.restype = ctypes.c_int
        _FNS = (sweep, solve_fn, smem)
    return _FNS


def bucket_capacity(Wg: int) -> int:
    """A grid capacity bucketed up to the next multiple of 128, minus 1."""
    return ((Wg + 1 + 127) // 128) * 128 - 1


def table_in_smem(I: int, J: int, wp1: int) -> bool:
    """Whether the solve keeps its choice table in shared memory (one byte
    per entry), as ``table_fits`` in the source decides."""
    return J <= 255 and _base_smem(I, J, wp1) + I * wp1 <= MAX_SMEM_BYTES


def _base_smem(I: int, J: int, wp1: int) -> int:
    return 4 * (I * J + J) + (8 * wp1 if wp1 > WARP_MAX else 0)


def smem_bytes(I: int, J: int, wp1: int, solve: bool) -> int:
    """Dynamic shared memory of one launch (``knapsack_dp_smem``): the
    utilities and costs, the block sweep's two value rows (W+1 > 256) and,
    for the solve, the one-byte choice table where it fits."""
    return _base_smem(I, J, wp1) + (
        I * wp1 if solve and table_in_smem(I, J, wp1) else 0)


def _check(util: torch.Tensor, costs: torch.Tensor, W: int) -> None:
    if util.device.type != "cuda" or costs.device != util.device:
        raise ValueError(f"the knapsack kernels need util and costs on one "
                         f"CUDA device, got {util.device} and {costs.device}")
    if util.dtype != torch.float32 or util.dim() != 2:
        raise ValueError(f"util must be (I, J) float32, got "
                         f"{tuple(util.shape)} {util.dtype}")
    I, J = util.shape
    if costs.dtype != torch.int32 or tuple(costs.shape) != (J,):
        raise ValueError(f"costs must be ({J},) int32, got "
                         f"{tuple(costs.shape)} {costs.dtype}")
    if not (util.is_contiguous() and costs.is_contiguous()):
        raise ValueError("util and costs must be contiguous")
    if W < 0 or J < 1:
        raise ValueError(f"need W >= 0 and J >= 1, got W={W}, J={J}")
    smem = _base_smem(I, J, W + 1)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"knapsack_dp needs {smem} bytes of shared memory "
                         f"for I={I}, J={J}, W+1={W + 1}; a block has "
                         f"{MAX_SMEM_BYTES}")


def knapsack_dp_cuda(util: torch.Tensor, costs: torch.Tensor, W: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sweep on the current stream: util (I, J) float32 and
    costs (J,) int32 (>= 0), both contiguous on one card, W >= 0 ->
    (values (W+1,) float32, choices (I, W+1) int32)."""
    global LAUNCHES
    W = int(W)
    _check(util, costs, W)
    I, J = util.shape
    vals = torch.empty((W + 1,), dtype=torch.float32, device=util.device)
    choices = torch.empty((I, W + 1), dtype=torch.int32, device=util.device)
    err = _fns()[0](util.data_ptr(), costs.data_ptr(), vals.data_ptr(),
                    choices.data_ptr(), I, J, W + 1,
                    torch.cuda.current_stream(util.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knapsack_dp kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return vals, choices


def knapsack_dp_solve_cuda(util: torch.Tensor, costs: torch.Tensor,
                           Wg, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the sweep at capacity W and the backtrack bounded by ``Wg``
    as one kernel on the current stream.  ``Wg`` is a 0-d int32 tensor on
    the same card (read there: no host sync) or a Python int.  Returns
    (picks (I,) int64, total 0-d float32), what ``ref.backtrack_device``
    returns for the plain sweep."""
    global LAUNCHES
    W = int(W)
    _check(util, costs, W)
    I, J = util.shape
    dev = util.device
    if isinstance(Wg, torch.Tensor):
        if Wg.device != dev or Wg.dtype != torch.int32 or Wg.dim() != 0:
            raise ValueError(f"Wg must be a 0-d int32 tensor on {dev}, got "
                             f"{tuple(Wg.shape)} {Wg.dtype} on {Wg.device}")
        wg_ptr, wg_int = Wg.data_ptr(), 0
    else:
        wg_ptr, wg_int = None, int(Wg)
    picks = torch.empty((I,), dtype=torch.int64, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    scratch = None if table_in_smem(I, J, W + 1) else torch.empty(
        (I, W + 1), dtype=torch.int32, device=dev)
    err = _fns()[1](util.data_ptr(), costs.data_ptr(), wg_ptr, wg_int,
                    picks.data_ptr(), total.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), I, J,
                    W + 1, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knapsack_dp solve launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return picks, total


def solve_values(util: torch.Tensor, costs: torch.Tensor, W: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DP sweep at capacity W: plain version on the CPU, kernel on
    CUDA -> (values (W+1,), choices (I, W+1) int32)."""
    if util.device.type == "cpu":
        return ref.knapsack_dp_ref(util, costs, int(W))
    return knapsack_dp_cuda(util.to(torch.float32).contiguous(),
                            costs.to(torch.int32).contiguous(), int(W))


def solve_device(util: torch.Tensor, costs: torch.Tensor, Wg: torch.Tensor,
                 *, w_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """DP sweep at the static capacity ``w_cap`` and a backtrack bounded by
    the 0-d capacity ``Wg`` (<= w_cap), all on the tensors' device: the
    plain sweep and ``ref.backtrack_device`` on the CPU, one kernel on
    CUDA.  Returns (picks (I,) int64, total)."""
    if util.device.type == "cpu":
        vals, choices = ref.knapsack_dp_ref(util, costs, int(w_cap))
        return ref.backtrack_device(choices, costs, vals, Wg)
    return knapsack_dp_solve_cuda(
        util.to(torch.float32).contiguous(),
        costs.to(torch.int32).contiguous(), Wg.to(torch.int32), int(w_cap))


def solve(util: np.ndarray, costs: np.ndarray, W: int, *,
          device=None) -> Tuple[np.ndarray, float]:
    """Host solve at capacity W on ``device`` (the card unless the caller
    asks for the CPU), the sweep at the bucketed capacity.  On the card one
    kernel sweeps and backtracks, and only the picks and the total come
    back; on the CPU the plain sweep's exact-W columns are walked in
    numpy.  Returns (picks (I,) int32, achieved total)."""
    dev = resolve_device(device)
    Wb = bucket_capacity(int(W))
    u = torch.as_tensor(np.asarray(util, np.float32), device=dev)
    c = torch.as_tensor(np.asarray(costs, np.int32), device=dev)
    if dev.type != "cpu":
        picks, total = knapsack_dp_solve_cuda(u, c, int(W), Wb)
        return picks.cpu().numpy().astype(np.int32), float(total)
    vals, choices = ref.knapsack_dp_ref(u, c, Wb)
    vals = vals.numpy()[:W + 1]
    choices = choices.numpy()[:, :W + 1]
    picks, _ = ref.backtrack(choices, np.asarray(costs), vals)
    return picks, float(vals.max())
