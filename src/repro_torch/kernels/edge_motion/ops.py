"""Edge-motion dispatch: the plain version for CPU tensors, the CUDA
kernel (``csrc/edge_motion.cu``) for CUDA tensors, nothing else."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.edge_motion import ref

# kernel launches since the last reset (compare-with-plain launches count
# too; callers reset it around the run they want to read)
LAUNCHES = 0


def edge_motion_cuda(frames: torch.Tensor, *, block_size: int,
                     edge_thresh: float) -> torch.Tensor:
    """Launch the kernel on ``frames`` (C, M, H, W) float32 contiguous on
    the card -> (C, M-1, H/bs, W/bs) on the current stream."""
    global LAUNCHES
    if frames.device.type != "cuda":
        raise ValueError(f"edge_motion_cuda needs a CUDA tensor, got "
                         f"{frames.device}")
    if frames.dtype != torch.float32 or frames.dim() != 4:
        raise ValueError(f"frames must be (C, M, H, W) float32, got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    C, M, H, W = frames.shape
    bs = int(block_size)
    if M < 2 or H % bs or W % bs:
        raise ValueError(f"need M >= 2 and H, W divisible by bs={bs}: "
                         f"{tuple(frames.shape)}")
    out = torch.empty((C, M - 1, H // bs, W // bs), dtype=torch.float32,
                      device=frames.device)
    lib = build.library("edge_motion")
    fn = lib.edge_motion_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(frames.data_ptr(), out.data_ptr(), C, M, H, W, bs,
             ref.edge_thresh2(edge_thresh),
             torch.cuda.current_stream(frames.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_motion kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out


def segment_motion_fleet(frames: torch.Tensor, *, block_size: int,
                         edge_thresh: float) -> torch.Tensor:
    """frames (C, M, H, W) -> (C, M-1, H/bs, W/bs) block motion scores of
    every consecutive frame pair."""
    if frames.device.type == "cpu":
        return ref.segment_motion_ref(frames, block_size=block_size,
                                      edge_thresh=edge_thresh)
    return edge_motion_cuda(frames.contiguous(), block_size=block_size,
                            edge_thresh=edge_thresh)


def segment_motion(frames: torch.Tensor, *, block_size: int,
                   edge_thresh: float) -> torch.Tensor:
    """One camera: frames (N, H, W) -> (N-1, H/bs, W/bs), through the fleet
    path with C = 1 (the kernel on the card)."""
    return segment_motion_fleet(frames[None], block_size=block_size,
                                edge_thresh=edge_thresh)[0]
