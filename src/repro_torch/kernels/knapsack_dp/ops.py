"""Knapsack DP dispatch: the plain sweep for CPU tensors, the CUDA kernel
(``csrc/knapsack_dp.cu``) for CUDA tensors, nothing else; plus the static
capacity bucket, the device solve (sweep + on-device backtrack) and the
host solve (sweep on a device, fetch, numpy backtrack)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.knapsack_dp import ref

# kernel launches since the last reset
LAUNCHES = 0

# shared memory one block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448


def bucket_capacity(Wg: int) -> int:
    """A grid capacity bucketed up to the next multiple of 128, minus 1."""
    return ((Wg + 1 + 127) // 128) * 128 - 1


def knapsack_dp_cuda(util: torch.Tensor, costs: torch.Tensor, W: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream: util (I, J) float32 and
    costs (J,) int32 (>= 0), both contiguous on one card, W >= 0 ->
    (values (W+1,) float32, choices (I, W+1) int32)."""
    global LAUNCHES
    if util.device.type != "cuda" or costs.device != util.device:
        raise ValueError(f"knapsack_dp_cuda needs util and costs on one "
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
    W = int(W)
    if W < 0 or J < 1:
        raise ValueError(f"need W >= 0 and J >= 1, got W={W}, J={J}")
    # two value rows, the util table and the costs (as the .cu sizes it)
    smem = 4 * (2 * (W + 1) + I * J + J)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"knapsack_dp needs {smem} bytes of shared memory "
                         f"for I={I}, J={J}, W+1={W + 1}; a block has "
                         f"{MAX_SMEM_BYTES}")
    vals = torch.empty((W + 1,), dtype=torch.float32, device=util.device)
    choices = torch.empty((I, W + 1), dtype=torch.int32, device=util.device)
    fn = build.library("knapsack_dp").knapsack_dp_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(util.data_ptr(), costs.data_ptr(), vals.data_ptr(),
             choices.data_ptr(), I, J, W + 1,
             torch.cuda.current_stream(util.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knapsack_dp kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return vals, choices


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
    the 0-d capacity ``Wg`` (<= w_cap), all on the tensors' device.
    Returns (picks (I,), total)."""
    vals, choices = solve_values(util, costs, int(w_cap))
    return ref.backtrack_device(choices, costs, vals, Wg)


def solve(util: np.ndarray, costs: np.ndarray, W: int, *,
          device=None) -> Tuple[np.ndarray, float]:
    """Host solve: sweep at the bucketed capacity on ``device`` (the card
    unless the caller asks for the CPU), fetch, keep the exact-W columns
    and backtrack in numpy.  Returns (picks (I,), achieved total)."""
    dev = resolve_device(device)
    Wb = bucket_capacity(int(W))
    vals, choices = solve_values(
        torch.as_tensor(np.asarray(util, np.float32), device=dev),
        torch.as_tensor(np.asarray(costs, np.int32), device=dev), Wb)
    vals = vals.cpu().numpy()[:W + 1]
    choices = choices.cpu().numpy()[:, :W + 1]
    picks, _ = ref.backtrack(choices, np.asarray(costs), vals)
    return picks, float(vals.max())
