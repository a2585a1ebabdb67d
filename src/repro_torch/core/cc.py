"""Connected components + box extraction on the block-motion grid.

The counterpart of ``repro.core.cc``: iterative min-label propagation
(each active cell takes the min label of its 4-neighbourhood until
fixpoint), segment min/max of rows and columns per root label, and the
top-``max_boxes`` components by bounding-box area.  Batched over cameras.

The labels come from the cc_label kernel (``kernels/cc_label``: one block
per camera loops to the fixpoint on the card, so no host read bounds the
loop) or, for CPU tensors, its plain version; both give the JAX package's
labels exactly.  Ties in area go to the lowest label first, like
``lax.top_k``; non-components all tie at -1.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.cc_label import ops as cc_ops
from repro_torch.kernels.cc_label.ref import INF


def label_and_boxes(mask: torch.Tensor, max_boxes: int = 16
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mask (C, M, N) bool -> (boxes (C, K, 4) int32 [x0, y0, x1, y1) in
    block coords, valid (C, K) bool, labels (C, M, N) int32), boxes sorted
    by area, largest first."""
    C, M, N = mask.shape
    dev = mask.device
    labels = cc_ops.cc_label(mask)

    flat = labels.reshape(C, -1).to(torch.int64)
    num_seg = M * N + 1
    seg = torch.where(flat == INF, M * N, flat)       # background -> seg M*N
    pos = torch.arange(M * N, dtype=torch.int64, device=dev)
    rows = (pos // N).expand(C, -1)
    cols = (pos % N).expand(C, -1)

    def seg_reduce(src, how):
        out = torch.zeros((C, num_seg), dtype=torch.int64, device=dev)
        return out.scatter_reduce(1, seg, src, how, include_self=False)

    r0, r1 = seg_reduce(rows, "amin"), seg_reduce(rows, "amax")
    c0, c1 = seg_reduce(cols, "amin"), seg_reduce(cols, "amax")
    cnt = torch.zeros((C, num_seg), dtype=torch.int64, device=dev).scatter_add(
        1, seg, torch.ones_like(seg))
    is_comp = cnt > 0
    is_comp[:, M * N] = False
    area = torch.where(is_comp, (r1 - r0 + 1) * (c1 - c0 + 1), -1)
    k = min(max_boxes, num_seg)
    top_idx = torch.sort(area, dim=1, descending=True,
                         stable=True).indices[:, :k]
    valid = torch.gather(area, 1, top_idx) > 0
    g = lambda v: torch.gather(v, 1, top_idx)
    boxes = torch.stack([g(c0), g(r0), g(c1) + 1, g(r1) + 1], dim=-1)
    boxes = torch.where(valid[..., None], boxes, 0).to(torch.int32)
    if k < max_boxes:
        boxes = torch.cat([boxes, boxes.new_zeros(C, max_boxes - k, 4)], 1)
        valid = torch.cat([valid, valid.new_zeros(C, max_boxes - k)], 1)
    return boxes, valid, labels
