"""ROIDet — regions of interest per camera segment (paper section 4, Alg. 1).

The counterpart of ``repro.core.roidet``'s fleet path: the light detector
on the first and last frame of every camera (stationary objects), the
edge-motion kernel over every consecutive frame pair (moving objects),
connected components of the thresholded motion grid, and the union of
both box sets dilated by one block.  Returns the block-grid ROI mask and
the content features the server consumes: a = ROI-area ratio, c = mean
on-camera detection confidence.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core import cc
from repro_torch.kernels.edge_motion import ops as em_ops
from repro_torch.models import detector as det

# shared defaults for every ROIDet entry point
MOTION_THRESH = 16.0
EDGE_THRESH = 0.35
CONF_THRESH = 0.25
MAX_BOXES = 16


class ROIResult(NamedTuple):
    mask: torch.Tensor          # (C, M, N) bool block-grid ROI coverage
    area_ratio: torch.Tensor    # (C,) in [0, 1] — feature a
    confidence: torch.Tensor    # (C,) in [0, 1] — feature c
    motion_boxes: torch.Tensor  # (C, K, 4) block coords
    motion_valid: torch.Tensor  # (C, K)
    det_boxes: torch.Tensor     # (C, 2K, 4) pixel coords
    det_valid: torch.Tensor     # (C, 2K)


def _boxes_to_mask(boxes: torch.Tensor, valid: torch.Tensor, M: int, N: int,
                   scale: float = 1.0) -> torch.Tensor:
    """Rasterise (C, K, 4) xyxy boxes (optionally pixel -> block scaled)
    onto (C, M, N)."""
    dev = boxes.device
    rows = torch.arange(M, device=dev, dtype=torch.float32)[:, None]
    cols = torch.arange(N, device=dev, dtype=torch.float32)[None, :]
    x0, y0, x1, y1 = (boxes[..., j].to(torch.float32)[..., None, None] * scale
                      for j in range(4))
    m = ((rows >= torch.floor(y0)) & (rows < torch.ceil(y1))
         & (cols >= torch.floor(x0)) & (cols < torch.ceil(x1)))
    return torch.any(m & valid[..., None, None], dim=1)


def _roi_union(D: torch.Tensor, dboxes: torch.Tensor, dvalid: torch.Tensor,
               block_size: int, max_boxes: int):
    """Motion components | detector boxes, dilated by one block.
    Returns (mask, area_ratio, motion_boxes, motion_valid)."""
    C, M, N = D.shape
    mboxes, mvalid, _ = cc.label_and_boxes(D, max_boxes=max_boxes)
    mask = (_boxes_to_mask(mboxes, mvalid, M, N)
            | _boxes_to_mask(dboxes, dvalid, M, N, scale=1.0 / block_size))
    p = torch.nn.functional.pad(mask, (1, 1, 1, 1))
    mask = (p[:, 1:-1, 1:-1] | p[:, :-2, 1:-1] | p[:, 2:, 1:-1]
            | p[:, 1:-1, :-2] | p[:, 1:-1, 2:])
    area = mask.to(torch.float32).sum(dim=(1, 2)) / float(M * N)
    return mask, area, mboxes, mvalid


def roidet_fleet(frames: torch.Tensor, det_params: Dict[str, torch.Tensor],
                 *, block_size: int = 8, motion_thresh: float = MOTION_THRESH,
                 edge_thresh: float = EDGE_THRESH,
                 conf_thresh: float = CONF_THRESH,
                 max_boxes: int = MAX_BOXES, mesh=None) -> ROIResult:
    """Fleet ROIDet: frames (C, N, H, W) -> camera-batched ROIResult (one
    light-detector forward on the 2C first/last frames, one edge-motion
    launch over every frame pair).  With a camera ``mesh``
    (``sharding.rules``) ``frames`` are the whole fleet's: each rank runs
    its rows of the padded fleet and every field is gathered and sliced
    back to C."""
    C = frames.shape[0]
    if mesh is not None:
        from repro_torch.sharding import rules
        res = roidet_fleet(rules.scatter(frames, mesh), det_params,
                           block_size=block_size, motion_thresh=motion_thresh,
                           edge_thresh=edge_thresh, conf_thresh=conf_thresh,
                           max_boxes=max_boxes)
        return ROIResult(*(rules.gather(x, mesh)[:C] for x in res))
    grid = det.forward(det_params, torch.cat([frames[:, 0], frames[:, -1]]))
    b2, s2, v2 = det.decode_boxes(grid, conf_thresh=conf_thresh)  # (2C, K)
    dboxes = torch.cat([b2[:C], b2[C:]], dim=1)                    # (C, 2K, 4)
    dscores = torch.cat([s2[:C], s2[C:]], dim=1)
    dvalid = torch.cat([v2[:C], v2[C:]], dim=1)
    conf = (torch.where(dvalid, dscores, 0.0).sum(dim=1)
            / torch.clamp(dvalid.sum(dim=1), min=1))
    scores = em_ops.segment_motion_fleet(frames, block_size=block_size,
                                         edge_thresh=edge_thresh)
    D = torch.any(scores > motion_thresh, dim=1)                   # (C, M, N)
    mask, area, mboxes, mvalid = _roi_union(D, dboxes, dvalid, block_size,
                                            max_boxes)
    return ROIResult(mask=mask, area_ratio=area, confidence=conf,
                     motion_boxes=mboxes, motion_valid=mvalid,
                     det_boxes=dboxes, det_valid=dvalid)


def full_frame_mask(num_cameras: int, H: int, W: int, block_size: int,
                    device) -> torch.Tensor:
    """All-ones block masks: 'no cropping' (the identity crop, pixel count
    exactly H*W)."""
    return torch.ones((num_cameras, H // block_size, W // block_size),
                      dtype=torch.bool, device=device)


def crop_to_mask(frames: torch.Tensor, masks: torch.Tensor,
                 block_size: int) -> torch.Tensor:
    """frames (C, N, H, W), masks (C, M, Nb): non-ROI blocks take the
    frame's mean (``frames * up + fill * (1 - up)`` with up in {0, 1})."""
    up = masks.repeat_interleave(block_size, dim=1).repeat_interleave(
        block_size, dim=2)[:, None]
    fill = frames.mean(dim=(2, 3), keepdim=True)
    return torch.where(up, frames, fill)
