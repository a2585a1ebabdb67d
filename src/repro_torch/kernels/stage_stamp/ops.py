"""Stage-mark dispatch: the CUDA kernel (``csrc/stage_stamp.cu``) for CUDA
tensors, the host's clock for CPU tensors, and for fake tensors
(``analysis.trace_cost``) a stand-in that records nothing, so that a
traced step's memory and cost are those of the stages alone."""
from __future__ import annotations

import ctypes
import time

import torch

from repro_torch.common.device import is_fake
from repro_torch.kernels import build

_LAUNCH = None


def _launcher():
    """The kernel's C entry point, its argument types bound once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = build.library("stage_stamp").stage_stamp_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _check(stamps: torch.Tensor, counter: torch.Tensor, k: int) -> None:
    if stamps.dtype != torch.int64 or stamps.dim() != 2 \
            or not stamps.is_contiguous():
        raise ValueError(f"stamps must be a contiguous (rows, cols) int64 "
                         f"tensor, got {tuple(stamps.shape)} {stamps.dtype}")
    if counter.dtype != torch.int64 or counter.numel() != 1:
        raise ValueError("counter must be one int64")
    if not 0 <= k < stamps.shape[1]:
        raise ValueError(f"mark {k} outside the {stamps.shape[1]} columns")


def stamp_cuda(stamps: torch.Tensor, counter: torch.Tensor, k: int) -> None:
    """Launch the kernel on the current stream: the card's %globaltimer
    (ns) into ``stamps[counter, k]`` when the work queued before it on the
    stream has finished."""
    _check(stamps, counter, k)
    err = _launcher()(stamps.data_ptr(), counter.data_ptr(),
                      stamps.shape[0], stamps.shape[1], int(k),
                      torch.cuda.current_stream(stamps.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stage_stamp kernel launch failed: cudaError "
                           f"{err}")


def stamp_ref(stamps: torch.Tensor, counter: torch.Tensor, k: int) -> None:
    """The plain version on CPU tensors: the host's monotonic clock (ns)
    into ``stamps[counter, k]``."""
    _check(stamps, counter, k)
    row = int(counter)
    if 0 <= row < stamps.shape[0]:
        stamps[row, k] = time.perf_counter_ns()


def stamp(stamps: torch.Tensor, counter: torch.Tensor, k: int) -> None:
    """Mark ``k`` of the slot row ``counter`` (a 0-d int64 on the stamps'
    device) in ``stamps`` ((rows, cols) int64): the kernel on the card,
    the host's clock on the CPU, nothing on fake tensors."""
    if is_fake(stamps, counter):
        return
    if stamps.device.type == "cpu":
        stamp_ref(stamps, counter, k)
    else:
        stamp_cuda(stamps, counter, k)
