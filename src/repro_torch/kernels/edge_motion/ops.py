"""Edge-motion dispatch: the plain version for CPU tensors, the CUDA
kernel (``csrc/edge_motion.cu``) for CUDA tensors, a stand-in for fake
tensors (``analysis.trace_cost``: the scores' shape and one launch),
nothing else; plus the kernel's launch plan (column segments and chunks
of frame pairs)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.common.device import is_fake, record_kernel, sm_count
from repro_torch.kernels import build
from repro_torch.kernels.edge_motion import ref

# kernel launches since the last reset (compare-with-plain launches count
# too; callers reset it around the run they want to read)
LAUNCHES = 0

MAX_SMEM_BYTES = 232448    # shared memory one block may use (227 KB)
MAX_BS = 32                # a block's row of bits fits one funnel shift
# a block's fixed cost (its copy round, barriers and launch) in edge words
# of work: any value from 2 to 10 picks the fastest of the plans that
# tools/kernel_probe.py times at (5, 10, 96, 160) and (16, 10, 96, 160)
BLOCK_WORDS = 5

_LAUNCH = None


def _launcher():
    """The kernel's C entry point, its argument types bound once."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = build.library("edge_motion").edge_motion_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def smem_bytes(bs: int, seg_blocks: int, ppc: int) -> int:
    """Dynamic shared memory of one block (``edge_motion_smem`` in the
    source): an 8-byte mbarrier per frame (rounded up to 16 bytes), the
    bs + 2 staged rows of ppc + 1 frames, each row the segment's
    seg_blocks * bs columns plus halo and 4-column bounds, and the frames'
    edge-map words (bs rows of ceil(width / 32) words)."""
    ws = seg_blocks * bs
    sw = (ws + 8 + 3) // 4 * 4
    nw = -(-ws // 32)
    bars = -(-(ppc + 1) * 8 // 16) * 16
    return bars + (ppc + 1) * ((bs + 2) * sw + bs * nw) * 4


def plan(C: int, M: int, H: int, W: int, bs: int, sms: int
         ) -> Tuple[int, int]:
    """(output blocks per column segment, frame pairs per chunk) for one
    launch.  All pairs of a camera go in one chunk, so that each frame is
    staged once, where the frames fit a block's shared memory at some
    segment width no narrower than one 32-column word of blocks; else the
    narrowest segment's chunks are as long as fit (each chunk restages its
    first frame).  Among the segment widths that fit, the plan takes the
    one whose busiest of the card's ``sms`` SMs has the least work: blocks
    per SM (rounded up) times the 32-column edge words of one block
    (frames times words per row) plus BLOCK_WORDS for the block's own
    cost; on a tie, the fewer blocks."""
    nb, nbands = W // bs, H // bs
    narrowest = max(1, min(nb, 32 // bs))
    best = None
    for nseg in range(1, -(-nb // narrowest) + 1):
        seg = -(-nb // nseg)
        if seg < narrowest or -(-nb // seg) != nseg or \
                smem_bytes(bs, seg, M - 1) > MAX_SMEM_BYTES:
            continue
        blocks = C * nbands * nseg
        words = -(-blocks // sms) * (M * -(-seg * bs // 32) + BLOCK_WORDS)
        if best is None or (words, blocks) < best[0]:
            best = ((words, blocks), seg)
    if best is not None:
        return best[1], M - 1
    ppc = M - 1
    while ppc > 1 and smem_bytes(bs, narrowest, ppc) > MAX_SMEM_BYTES:
        ppc -= 1
    return narrowest, ppc


def edge_motion_cuda(frames: torch.Tensor, *, block_size: int,
                     edge_thresh: float) -> torch.Tensor:
    """Launch the kernel on ``frames`` (C, M, H, W) float32 contiguous on
    the card -> (C, M-1, H/bs, W/bs) on the current stream, under
    ``plan(...)`` for the card's SM count."""
    return _launch(frames, block_size, edge_thresh, None)


def _launch(frames: torch.Tensor, block_size: int, edge_thresh: float,
            launch_plan: Optional[Tuple[int, int]]) -> torch.Tensor:
    """``edge_motion_cuda`` under ``launch_plan`` (segment blocks, pairs per
    chunk) where one is given: the tests hold other plans than the chosen
    one to the plain version through it."""
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
    if M < 2 or not 1 <= bs <= MAX_BS or H % bs or W % bs:
        raise ValueError(f"need M >= 2, 1 <= bs <= {MAX_BS} and H, W "
                         f"divisible by bs={bs}: {tuple(frames.shape)}")
    seg, ppc = launch_plan or plan(C, M, H, W, bs, sm_count(frames.device))
    if not (1 <= seg <= W // bs and 1 <= ppc <= M - 1) or \
            smem_bytes(bs, seg, ppc) > MAX_SMEM_BYTES:
        raise ValueError(f"plan {(seg, ppc)} does not fit "
                         f"{tuple(frames.shape)} at bs={bs}")
    out = torch.empty((C, M - 1, H // bs, W // bs), dtype=torch.float32,
                      device=frames.device)
    err = _launcher()(frames.data_ptr(), out.data_ptr(), C, M, H, W, bs,
                      ref.edge_thresh2(edge_thresh), seg, ppc,
                      torch.cuda.current_stream(frames.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edge_motion kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out


def edge_motion_stand_in(frames: torch.Tensor, block_size: int
                         ) -> torch.Tensor:
    """The kernel on fake tensors (``analysis.trace_cost``): its scores
    at their shape and one launch with the bound's operations and
    bytes."""
    C, M, H, W = frames.shape
    bs = int(block_size)
    px = C * M * H * W
    record_kernel(
        "edge_motion", px * 15 + C * (M - 1) * H * W * 2,
        4 * (px + C * (M - 1) * (H // bs) * (W // bs)))
    return torch.empty((C, M - 1, H // bs, W // bs), dtype=torch.float32,
                       device=frames.device)


def segment_motion_fleet(frames: torch.Tensor, *, block_size: int,
                         edge_thresh: float) -> torch.Tensor:
    """frames (C, M, H, W) -> (C, M-1, H/bs, W/bs) block motion scores of
    every consecutive frame pair (a stand-in on fake tensors)."""
    if is_fake(frames):
        return edge_motion_stand_in(frames, block_size)
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
