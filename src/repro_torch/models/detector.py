"""Single-scale anchor-free conv detector: inference, box decode, greedy F1.

The counterpart of ``repro.models.detector``.  Two widths share the code:
``light`` (8, 16, 32, 32), the on-camera ROIDet model, and ``server``
(16, 32, 64, 64), whose F1 is the system's utility.  Weights are the JAX
package's committed checkpoints (``load_detector``), converted to OIHW,
or trained by ``train/detector_train.py`` from ``init_detector`` on
``detection_loss``.

Numerics that must follow XLA to keep discrete outputs equal:
  * ``"SAME"`` padding at stride 2 pads (lo, hi) = (0, 1) on even sizes;
    ``_same_pad`` computes XLA's split for any size;
  * ``lax.top_k`` and ``jnp.argsort`` put the lowest index first among
    equal values (saturated sigmoids tie at exactly 1.0, unmatched preds at
    -1), so both are stable sorts here;
  * gradients at exact ties follow JAX's: at init the biases are zero, so
    an objectness logit can be exactly 0, where ``jnp.abs`` has gradient 1
    (``torch.abs`` 0) and ``jnp.maximum(x, 0)`` splits 0.5/0.5 (as
    ``torch.maximum``; ``clamp(min=0)`` gives 1): ``detection_loss``
    writes ``|x|`` as ``where(x >= 0, x, -x)`` and uses ``torch.maximum``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.common.convert import params_from_numpy
from repro_torch.common.params import ParamDef, init_params

STRIDE = 16
WIDTHS = {"light": (8, 16, 32, 32), "server": (16, 32, 64, 64)}
ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"

Params = Dict[str, torch.Tensor]


def load_detector(variant: str, device) -> Params:
    """The committed ``artifacts/detector_<variant>`` weights on ``device``."""
    tree, _ = ckpt.restore(ARTIFACTS / f"detector_{variant}")
    params = params_from_numpy(tree, "detector", device=device)
    if params["c1"].shape[0] != WIDTHS[variant][0]:
        raise ValueError(f"checkpoint width {params['c1'].shape[0]} does "
                         f"not match the {variant} detector")
    return params


def _conv_def(cin: int, cout: int, k: int = 3) -> ParamDef:
    return ParamDef((k, k, cin, cout), "normal", 1.4)


def detector_defs(variant: str = "light") -> Dict[str, ParamDef]:
    """The JAX declaration: convolution kernels in HWIO, zero biases."""
    c1, c2, c3, c4 = WIDTHS[variant]
    return {
        "c1": _conv_def(1, c1), "b1": ParamDef((c1,), "zeros"),
        "c2": _conv_def(c1, c2), "b2": ParamDef((c2,), "zeros"),
        "c3": _conv_def(c2, c3), "b3": ParamDef((c3,), "zeros"),
        "c4": _conv_def(c3, c4), "b4": ParamDef((c4,), "zeros"),
        "head": _conv_def(c4, 5, k=1), "bh": ParamDef((5,), "zeros"),
    }


def init_detector(key: torch.Tensor, variant: str = "light") -> Params:
    """JAX's ``init_detector(key, variant)`` bit for bit: the threefry
    draws of ``init_params`` in HWIO, then the kernels moved to OIHW, on
    the key's device."""
    return {k: v.permute(3, 2, 0, 1).contiguous() if v.dim() == 4 else v
            for k, v in init_params(key, detector_defs(variant)).items()}


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int) -> torch.Tensor:
    k = w.shape[-1]
    ph, pw = _same_pad(x.shape[2], k, stride), _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride=stride)


def forward(params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, H, W) in [0, 1] -> raw grid (B, H/16, W/16, 5)."""
    x = frames[:, None]
    for i in (1, 2, 3, 4):
        x = torch.relu(_conv(x, params[f"c{i}"], params[f"b{i}"], 2))
    y = _conv(x, params["head"], params["bh"], 1)
    return y.permute(0, 2, 3, 1)


def encode_targets(boxes: List[Tuple[int, int, int, int]], gy: int, gx: int
                   ) -> np.ndarray:
    """GT boxes (xyxy) -> target grid (Gy, Gx, 5) [obj, dy, dx, logw, logh]."""
    t = np.zeros((gy, gx, 5), np.float32)
    for (x0, y0, x1, y1) in boxes:
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        gxi = int(np.clip(cx // STRIDE, 0, gx - 1))
        gyi = int(np.clip(cy // STRIDE, 0, gy - 1))
        t[gyi, gxi, 0] = 1.0
        t[gyi, gxi, 1] = cy / STRIDE - gyi
        t[gyi, gxi, 2] = cx / STRIDE - gxi
        t[gyi, gxi, 3] = np.log(max(x1 - x0, 1) / STRIDE)
        t[gyi, gxi, 4] = np.log(max(y1 - y0, 1) / STRIDE)
    return t


def detection_loss(params: Params, frames: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """4 x the objectness BCE (mean over cells) + the box regression's
    squared error summed over positive cells / their count."""
    grid = forward(params, frames)
    obj_t = targets[..., 0]
    x = grid[..., 0]
    abs_x = torch.where(x >= 0, x, -x)     # gradient 1 at 0, as jnp.abs
    bce = torch.mean(torch.maximum(x, torch.zeros_like(x)) - x * obj_t
                     + torch.log1p(torch.exp(-abs_x)))
    pos = obj_t > 0.5
    pred_off = torch.stack([torch.sigmoid(grid[..., 1]),
                            torch.sigmoid(grid[..., 2]),
                            grid[..., 3], grid[..., 4]], -1)
    sq = torch.where(pos[..., None], (pred_off - targets[..., 1:]) ** 2, 0.0)
    l2 = torch.sum(sq) / torch.clamp(pos.sum().to(torch.float32), min=1.0)
    return bce * 4.0 + l2


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., Ka, 4), b (..., Kb, 4) -> IoU (..., Ka, Kb)."""
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


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, lowest index first
    among equal values."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def decode_boxes(grid: torch.Tensor, conf_thresh: float = 0.3,
                 k: int = 16
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """grid (B, Gy, Gx, 5) -> boxes (B, K, 4 xyxy), scores (B, K),
    valid (B, K) after greedy NMS at IoU 0.45."""
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
    scores, idx = top_k(flat_s, k)
    sel = torch.gather(flat_b, 1, idx[..., None].expand(B, k, 4))
    valid = scores > conf_thresh
    iou = box_iou(sel, sel)                                   # (B, K, K)
    keep = torch.ones((B, k), dtype=torch.bool, device=dev)
    for i in range(1, k):
        over = (iou[:, i, :i] > 0.45) & keep[:, :i] & valid[:, :i]
        keep[:, i] = ~torch.any(over, dim=-1)
    return sel, scores, valid & keep


def f1_score_batch(pred_boxes: torch.Tensor, pred_valid: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   iou_thresh: float = 0.3) -> torch.Tensor:
    """Greedy one-to-one F1 per frame: (B,K,4),(B,K),(B,G,4),(B,G) -> (B,).

    Preds are visited in descending best-IoU order (stable), each matching
    only its argmax GT (first max) if unmatched and IoU >= ``iou_thresh``:
    ``repro.models.detector.f1_score_padded`` batched over frames."""
    B, K = pred_valid.shape
    G = gt_valid.shape[1]
    dev = pred_boxes.device
    iou = box_iou(pred_boxes, gt_boxes)                            # (B, K, G)
    pair_ok = pred_valid[:, :, None] & gt_valid[:, None, :]
    iou_m = torch.where(pair_ok, iou, -1.0)
    order = torch.sort(-iou_m.max(dim=2).values, dim=1, stable=True).indices
    bi = torch.arange(B, device=dev)
    matched = torch.zeros((B, G), dtype=torch.bool, device=dev)
    tp = torch.zeros((B,), dtype=torch.int32, device=dev)
    for p in range(K):
        i = order[:, p]
        row = iou_m[bi, i]                                         # (B, G)
        j = torch.argmax(row, dim=1)
        ok = pred_valid[bi, i] & (row[bi, j] >= iou_thresh) & ~matched[bi, j]
        matched[bi, j] |= ok
        tp = tp + ok.to(torch.int32)
    n_pred = pred_valid.sum(dim=1)
    n_gt = gt_valid.sum(dim=1)
    tpf = tp.to(torch.float32)
    prec = tpf / torch.clamp(n_pred, min=1)
    rec = tpf / torch.clamp(n_gt, min=1)
    f1 = torch.where(tp == 0, 0.0,
                     2 * prec * rec / torch.clamp(prec + rec, min=1e-9))
    both_empty = (n_pred == 0) & (n_gt == 0)
    either_empty = (n_pred == 0) | (n_gt == 0)
    return torch.where(both_empty, 1.0, torch.where(either_empty, 0.0, f1))


def f1_score(pred_boxes, pred_valid, gt_boxes: List[Tuple[float, ...]],
             iou_thresh: float = 0.3) -> float:
    """Greedy one-to-one matching F1 for one frame on the host: preds (K,
    4) with their valid flags against a list of GT boxes (the sequential
    runner's scorer)."""
    preds = [tuple(b) for b, v in zip(np.asarray(pred_boxes),
                                      np.asarray(pred_valid)) if v]
    if not preds and not gt_boxes:
        return 1.0
    if not preds or not gt_boxes:
        return 0.0
    a = torch.from_numpy(np.array(preds, np.float32))
    b = torch.from_numpy(np.array(gt_boxes, np.float32))
    iou = box_iou(a, b).numpy()
    matched_gt: set = set()
    tp = 0
    for i in np.argsort(-iou.max(axis=1)):
        j = int(np.argmax(iou[i]))
        if iou[i, j] >= iou_thresh and j not in matched_gt:
            matched_gt.add(j)
            tp += 1
    prec = tp / len(preds)
    rec = tp / len(gt_boxes)
    return 0.0 if tp == 0 else 2 * prec * rec / (prec + rec)
