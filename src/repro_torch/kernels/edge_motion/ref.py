"""Plain PyTorch version of the edge-motion kernel (Algorithm 1, l.3-9).

Per consecutive frame pair: squared Sobel magnitude on edge-replicated
borders -> edge map ``|g|^2 > edge_thresh^2`` -> XOR of the two maps ->
sum over bs x bs blocks.  The arithmetic is that of
``repro.kernels.edge_motion.ref`` in the same order with no fused
multiply-add (what XLA's CPU code does for the batched reference), so the
block counts are bitwise those of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F



def edge_thresh2(edge_thresh: float) -> float:
    """The float32 threshold the edge maps compare against."""
    return float(np.float32(edge_thresh * edge_thresh))


def sobel_mag2(frames: torch.Tensor) -> torch.Tensor:
    """frames (..., H, W) -> squared Sobel gradient magnitude (..., H, W)."""
    lead = frames.shape[:-2]
    x = F.pad(frames.reshape(-1, 1, *frames.shape[-2:]), (1, 1, 1, 1),
              mode="replicate")[:, 0]
    tl, tc, tr = x[:, :-2, :-2], x[:, :-2, 1:-1], x[:, :-2, 2:]
    ml, mr = x[:, 1:-1, :-2], x[:, 1:-1, 2:]
    bl, bc, br = x[:, 2:, :-2], x[:, 2:, 1:-1], x[:, 2:, 2:]
    gx = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    gy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    return (gx * gx + gy * gy).reshape(*lead, *gx.shape[-2:])


def segment_motion_ref(frames: torch.Tensor, *, block_size: int,
                       edge_thresh: float) -> torch.Tensor:
    """frames (C, M, H, W) -> (C, M-1, H/bs, W/bs) block motion scores of
    every consecutive pair."""
    C, M, H, W = frames.shape
    bs = block_size
    e = sobel_mag2(frames) > edge_thresh2(edge_thresh)
    d = (e[:, :-1] ^ e[:, 1:]).to(torch.float32)
    return d.reshape(C, M - 1, H // bs, bs, W // bs, bs).sum(dim=(3, 5))
