"""``conv4``: the repo's single-scale anchor-free detector, in plain torch.

Four stride-2 3 x 3 convolutions with ReLU ("SAME" padding as XLA splits
it), then a 1 x 1 head of five outputs (objectness, the centre's two
offsets inside its 16-pixel cell, log width and log height); decoded with
a stable top-k and greedy NMS at IoU 0.45.  The light (ROIDet) detector
and, in the ``conv4`` configurations, the server detector share it at
their own widths.  The weights are read from the committed checkpoint
files, which the program reads too.
"""
from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core.flops import detector_flops

STRIDE = 16
_CONVS = ("c1", "c2", "c3", "c4", "head")


def load_detector(path: Path, device) -> Dict[str, torch.Tensor]:
    """A committed detector checkpoint (manifest + zlib leaves, kernels in
    HWIO) -> float32 tensors, kernels in OIHW."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    blobs: Dict[str, bytes] = {}
    out = {}
    for leaf, ent in manifest["leaves"].items():
        name = leaf[2:-2]                       # "['c1']" -> "c1"
        if ent.get("codec", "zlib") != "zlib":
            raise ValueError(f"{path}: leaf {leaf} codec {ent['codec']}")
        blob = blobs.setdefault(ent["file"],
                                (path / ent["file"]).read_bytes())
        raw = zlib.decompress(blob[ent["offset"]:ent["offset"]
                                   + ent["nbytes"]])
        a = np.frombuffer(raw, dtype=ent["dtype"]).reshape(ent["shape"])
        a = a.astype(np.float32)
        if name in _CONVS:
            a = np.transpose(a, (3, 2, 0, 1))
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride):
    k = w.shape[-1]
    ph, pw = _same_pad(x.shape[2], k, stride), _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride=stride)


def detector_forward(params, frames: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """frames (B, H, W) -> raw grid (B, H/16, W/16, 5) in float32, the
    convolutions computed in ``dtype``."""
    p = params if dtype == torch.float32 else {
        k: v.to(dtype) for k, v in params.items()}
    x = frames[:, None].to(dtype)
    for i in (1, 2, 3, 4):
        x = torch.relu(_conv(x, p[f"c{i}"], p[f"b{i}"], 2))
    y = _conv(x, p["head"], p["bh"], 1)
    return y.permute(0, 2, 3, 1).to(torch.float32)


def box_iou(a, b):
    ax0, ay0, ax1, ay1 = a.unbind(-1)
    bx0, by0, bx1, by1 = b.unbind(-1)
    ix0 = torch.maximum(ax0[..., :, None], bx0[..., None, :])
    iy0 = torch.maximum(ay0[..., :, None], by0[..., None, :])
    ix1 = torch.minimum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.minimum(ay1[..., :, None], by1[..., None, :])
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    area_a = torch.clamp((ax1 - ax0) * (ay1 - ay0), min=0)
    area_b = torch.clamp((bx1 - bx0) * (by1 - by0), min=0)
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-6)


def decode_boxes(grid, conf_thresh: float, k: int = 16):
    """grid (B, Gy, Gx, 5) -> boxes (B, K, 4), scores (B, K), valid (B, K)
    after greedy NMS at IoU 0.45; top-k puts the lowest index first among
    equal scores."""
    B, Gy, Gx, _ = grid.shape
    dev = grid.device
    obj = torch.sigmoid(grid[..., 0])
    cy = (torch.arange(Gy, device=dev, dtype=torch.float32)[:, None]
          + torch.sigmoid(grid[..., 1])) * STRIDE
    cx = (torch.arange(Gx, device=dev, dtype=torch.float32)[None, :]
          + torch.sigmoid(grid[..., 2])) * STRIDE
    bw = torch.exp(torch.clamp(grid[..., 3], -4, 4)) * STRIDE
    bh = torch.exp(torch.clamp(grid[..., 4], -4, 4)) * STRIDE
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        -1)
    flat_s = obj.reshape(B, -1)
    flat_b = boxes.reshape(B, -1, 4)
    k = min(k, flat_s.shape[1])
    idx = torch.sort(flat_s, dim=-1, descending=True, stable=True).indices[
        ..., :k]
    scores = torch.gather(flat_s, -1, idx)
    sel = torch.gather(flat_b, 1, idx[..., None].expand(B, k, 4))
    valid = scores > conf_thresh
    iou = box_iou(sel, sel)
    keep = torch.ones((B, k), dtype=torch.bool, device=dev)
    for i in range(1, k):
        over = (iou[:, i, :i] > 0.45) & keep[:, :i] & valid[:, :i]
        keep[:, i] = ~torch.any(over, dim=-1)
    return sel, scores, valid & keep


# -- the server detector's interface (see ``__init__``) ------------------------

def load(config: Dict, weights_dir: Path, device):
    """The server checkpoint that ``detectors.server`` names, read from
    ``weights_dir``."""
    name = Path(config["detectors"]["server"]).name
    return load_detector(Path(weights_dir) / name, device)


def forward(params, frames: torch.Tensor, dtype: torch.dtype):
    return detector_forward(params, frames, dtype)


def decode(raw, conf_thresh: float, k: int = 16):
    return decode_boxes(raw, conf_thresh, k)


def flops(config: Dict) -> int:
    """One frame at the scene's size, at ``detectors.server_widths``."""
    sc = config["scene"]
    return detector_flops(config["detectors"]["server_widths"],
                          int(sc["height"]), int(sc["width"]))
