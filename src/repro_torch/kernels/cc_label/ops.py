"""Connected-component labeling dispatch: the plain version for CPU
tensors, the CUDA kernel (``csrc/cc_label.cu``) for CUDA tensors, a
stand-in for fake tensors (``analysis.trace_cost``: the labels' shape
and one launch), nothing else."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.device import is_fake, record_kernel
from repro_torch.kernels import build
from repro_torch.kernels.cc_label import ref

# kernel launches since the last reset
LAUNCHES = 0

_FNS = None


def _fns():
    """The launch entry point, its argument types bound once, and the
    card's shared-memory limit per block (read once)."""
    global _FNS
    if _FNS is None:
        lib = build.library("cc_label")
        launch = lib.cc_label_launch
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        limit = lib.cc_label_smem_limit
        limit.argtypes = []
        limit.restype = ctypes.c_int
        _FNS = (launch, limit())
    return _FNS


def smem_bytes(M: int, N: int) -> int:
    """Dynamic shared memory of one block: the camera's int32 label grid."""
    return 4 * M * N


def cc_label_cuda(mask: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream: mask (C, M, N) bool,
    contiguous on the card -> labels (C, M, N) int32."""
    global LAUNCHES
    if mask.device.type != "cuda":
        raise ValueError(f"cc_label_cuda needs a CUDA tensor, got "
                         f"{mask.device}")
    if mask.dtype != torch.bool or mask.dim() != 3 or mask.numel() == 0:
        raise ValueError(f"mask must be a non-empty (C, M, N) bool tensor, "
                         f"got {tuple(mask.shape)} {mask.dtype}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    C, M, N = mask.shape
    launch, cap = _fns()
    smem = smem_bytes(M, N)
    if smem > cap:
        raise ValueError(f"cc_label: a ({M}, {N}) grid needs {smem} bytes of "
                         f"shared memory per block; this card gives {cap}")
    labels = torch.empty((C, M, N), dtype=torch.int32, device=mask.device)
    err = launch(mask.data_ptr(), labels.data_ptr(), C, M, N,
                 torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cc_label kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return labels


def cc_label_stand_in(mask: torch.Tensor) -> torch.Tensor:
    """The kernel on fake tensors (``analysis.trace_cost``): the labels
    at their shape and one launch with the bound's bytes and one pass's
    operations (the passes depend on the mask's values)."""
    C, M, N = mask.shape
    record_kernel("cc_label", 5 * C * M * N, 5 * C * M * N)
    return torch.empty((C, M, N), dtype=torch.int32, device=mask.device)


def cc_label(mask: torch.Tensor) -> torch.Tensor:
    """mask (C, M, N) bool -> labels (C, M, N) int32 (each component's
    least row-major cell index, 2^30 on the background): plain version on
    the CPU, kernel on CUDA, stand-in on fake tensors."""
    if is_fake(mask):
        return cc_label_stand_in(mask)
    if mask.device.type == "cpu":
        return ref.cc_label_ref(mask)
    return cc_label_cuda(mask.contiguous())
