"""Ultralytics YOLOv8 as the fleet's server detector: inference, box
decode, seeded weights.

The architecture is ``ultralytics/cfg/models/v8/yolov8.yaml`` at scale
``s`` (depth 0.33, width 0.50, max channels 1024): a Conv-BN-SiLU stem,
C2f stages, SPPF, the PAN neck (nearest upsampling, concatenation) and
the decoupled anchor-free ``Detect`` head at strides 8, 16 and 32 with
DFL (``reg_max`` 16) and 80 classes; 11,166,544 learnable parameters
(11,166,560 with DFL's fixed bins), 28.6 GFLOPs at 640 x 640.

Inference runs as Ultralytics' predictor runs it: each BatchNorm folded
into its convolution at load (``fuse_conv_and_bn``), the frames
letterboxed to ``imgsz`` and the head's output (boxes xywh in input
pixels, sigmoid class scores, one column per anchor) decoded by
confidence filter and greedy NMS, the boxes scaled back to the frame.
What the fleet changes: the grey frames are repeated to three channels;
the NMS is class-agnostic, as the scene's ground truth has no classes,
over the ``nms_candidates`` best anchors (a stable sort), and the first
``k`` kept boxes are the detections the fleet scores.  Greedy NMS keeps a
candidate when no earlier kept one overlaps it, so these equal a full
NMS's first ``k`` whenever the ``k``-th keep falls among the candidates;
``decode`` counts the frames where it may not (``overflow``).

No trained weights are in the repository.  ``init_params`` draws seeded
random ones (``weights_seed``) by a fixed recipe (``init_params``'s
docstring) that keeps activations O(1) through the 22 layers, puts the
DFL boxes in the scene's object sizes and sets the class bias
(``cls_bias``) so that some tens to hundreds of a frame's 5,040 anchors
pass the threshold.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.detector import box_iou

# (depth multiple, width multiple, max channels) of the published scales
SCALES = {"s": (0.33, 0.50, 1024)}
NUM_CLASSES = 80
REG_MAX = 16
STRIDES = (8, 16, 32)
BN_EPS = 1e-3
# Ultralytics' predict defaults
CONF = 0.25
IOU = 0.7
# the class branch's last bias: on the fleet's served frames (C = 16, the
# soak stream) a live frame's median count of anchors above CONF is ~120
# of 5,040 and ~70% of them score F1 > 0 with seeded weights 0
CLS_BIAS = -4.0

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ConvDef:
    """One convolution of the model: ``name`` (its place in the yaml's
    layers), in and out channels, kernel size, stride; ``bn`` False for
    the head's last 1 x 1 convolutions, which have a bias and no BN."""
    name: str
    cin: int
    cout: int
    k: int
    stride: int = 1
    bn: bool = True


def _width(c: int, scale: str) -> int:
    _, w, max_c = SCALES[scale]
    return int(math.ceil(min(c, max_c) * w / 8) * 8)


def _depth(n: int, scale: str) -> int:
    return max(round(n * SCALES[scale][0]), 1)


def architecture(scale: str = "s") -> Tuple[List[tuple], List[ConvDef]]:
    """The yaml's 23 layers at ``scale``: (layer list, every convolution
    in the order the weights are drawn).  A layer is ``(kind, name, args)``
    with kind ``conv`` (a ConvDef), ``c2f`` (cv1, bottlenecks, cv2,
    shortcut), ``sppf`` (cv1, cv2), ``up``, ``cat`` (the layers joined) or
    ``detect``."""
    if scale not in SCALES:
        raise ValueError(f"YOLOv8 scale {scale!r} is not one of "
                         f"{sorted(SCALES)}")
    ch: List[int] = []
    layers: List[tuple] = []
    convs: List[ConvDef] = []

    def conv(name, cin, cout, k, stride=1, bn=True) -> ConvDef:
        c = ConvDef(name, cin, cout, k, stride, bn)
        convs.append(c)
        return c

    def c2f(i, cin, cout, n, shortcut):
        c = cout // 2
        cv1 = conv(f"{i}.cv1", cin, 2 * c, 1)
        m = [(conv(f"{i}.m.{j}.cv1", c, c, 3), conv(f"{i}.m.{j}.cv2", c, c, 3))
             for j in range(n)]
        cv2 = conv(f"{i}.cv2", (2 + n) * c, cout, 1)
        layers.append(("c2f", str(i), (cv1, m, cv2, shortcut)))
        ch.append(cout)

    def plain(i, cin, cout, k, s):
        layers.append(("conv", str(i), conv(str(i), cin, cout, k, s)))
        ch.append(cout)

    w = lambda c: _width(c, scale)
    d = lambda n: _depth(n, scale)
    # backbone
    plain(0, 3, w(64), 3, 2)
    plain(1, w(64), w(128), 3, 2)
    c2f(2, w(128), w(128), d(3), True)
    plain(3, w(128), w(256), 3, 2)
    c2f(4, w(256), w(256), d(6), True)
    plain(5, w(256), w(512), 3, 2)
    c2f(6, w(512), w(512), d(6), True)
    plain(7, w(512), w(1024), 3, 2)
    c2f(8, w(1024), w(1024), d(3), True)
    c_ = w(1024) // 2
    layers.append(("sppf", "9", (conv("9.cv1", w(1024), c_, 1),
                                 conv("9.cv2", 4 * c_, w(1024), 1))))
    ch.append(w(1024))
    # PAN neck
    for i, (src, cout, down) in zip(range(10, 22, 3), (
            (6, w(512), False), (4, w(256), False), (12, w(512), True),
            (9, w(1024), True))):
        if down:
            plain(i, ch[-1], ch[-1], 3, 2)
        else:
            layers.append(("up", str(i), None))
            ch.append(ch[-1])
        layers.append(("cat", str(i + 1), (i, src)))
        ch.append(ch[-1] + ch[src])
        c2f(i + 2, ch[-1], cout, d(3), False)
    # Detect over layers 15, 18, 21
    feats = (15, 18, 21)
    c2 = max(16, ch[15] // 4, 4 * REG_MAX)
    c3 = max(ch[15], min(NUM_CLASSES, 100))
    box = [[conv(f"22.cv2.{i}.0", ch[f], c2, 3), conv(f"22.cv2.{i}.1", c2, c2, 3),
            conv(f"22.cv2.{i}.2", c2, 4 * REG_MAX, 1, bn=False)]
           for i, f in enumerate(feats)]
    cls = [[conv(f"22.cv3.{i}.0", ch[f], c3, 3), conv(f"22.cv3.{i}.1", c3, c3, 3),
            conv(f"22.cv3.{i}.2", c3, NUM_CLASSES, 1, bn=False)]
           for i, f in enumerate(feats)]
    layers.append(("detect", "22", (feats, box, cls)))
    return layers, convs


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the detector's code depends on besides its tensors."""
    scale: str = "s"
    imgsz: Tuple[int, int] = (384, 640)
    conf: float = CONF
    iou: float = IOU
    nms_candidates: int = 64
    frame_hw: Tuple[int, int] = (96, 160)   # the fleet's frames


def _box_bias(level: int) -> torch.Tensor:
    """The box branch's last bias: each side's 16 DFL logits peaked at
    ``BOX_BINS[level]``, so that a side's expectation lies near it (in
    strides)."""
    j = torch.arange(REG_MAX, dtype=torch.float32)
    return (-0.5 * (j - BOX_BINS[level]) ** 2).repeat(4)


# each level's DFL peak, in strides: sides of 3 x 8, 2 x 16 and 1.25 x 32
# input pixels, boxes of 48, 64 and 80 input pixels, 12, 16 and 20 frame
# pixels at the fleet's x 4 letterbox
BOX_BINS = (3.0, 2.0, 1.25)


# the calibration frames' noise: about the codec's on the frames served
CALIB_NOISE = 0.06


def calibration_frames(g: torch.Generator, frame_hw: Tuple[int, int]
                       ) -> torch.Tensor:
    """Two frames (2, H, W) drawn from ``g`` like the fleet's served ones:
    a background of 8 x 8 blocks ``U(0.25, 0.55)``, eight rectangles of
    8-25 pixels a side at ``U(0.6, 1)``, N(0, ``CALIB_NOISE``^2) noise,
    clipped to [0, 1].  Per frame: the blocks, then each rectangle's (x, y,
    w, h, value) as 5 uniforms, then the noise."""
    H, W = frame_hw
    out = []
    for _ in range(2):
        blocks = 0.25 + 0.3 * torch.rand((-(-H // 8), -(-W // 8)),
                                         generator=g)
        f = blocks.repeat_interleave(8, 0).repeat_interleave(8, 1)[:H, :W]
        f = f.clone()
        for u in torch.rand((8, 5), generator=g).tolist():
            w, h = 8 + int(18 * u[2]), 8 + int(18 * u[3])
            x, y = int((W - w) * u[0]), int((H - h) * u[1])
            f[y:y + h, x:x + w] = 0.6 + 0.4 * u[4]
        out.append((f + CALIB_NOISE * torch.randn((H, W), generator=g))
                   .clamp(0, 1))
    return torch.stack(out)


def init_params(scale: str = "s", imgsz=(384, 640), frame_hw=(96, 160),
                weights_seed: int = 0, cls_bias: float = CLS_BIAS
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Seeded random weights, BN unfolded: {conv name: {"w", and "gamma",
    "beta", "mean", "var" or "b"}} in float32 on the CPU.

    One ``torch.Generator().manual_seed(weights_seed)`` draws, convolution
    by convolution in ``architecture``'s order (the yaml's layers; inside
    C2f cv1, the bottlenecks, cv2; Detect's box branches then its class
    branches): for a BN convolution the kernel ``randn * sqrt(2 /
    fan_in)`` (Kaiming normal, gain sqrt 2), then ``cout`` values each of
    gamma ``0.5 + 0.5 * rand``, beta ``0.1 * randn``, a mean offset ``0.1
    * randn`` and a variance factor ``0.8 + 0.4 * rand``; for the head's
    last 1 x 1 convolutions the kernel ``(2 * rand - 1) / sqrt(fan_in)``
    (PyTorch's default, which Ultralytics' Detect keeps) and a bias that
    is set, not drawn: the box branch's ``_box_bias``, the class branch's
    the constant ``cls_bias``.  Then ``calibration_frames`` at
    ``frame_hw``, letterboxed to ``imgsz`` as the input is.

    The running statistics are the calibration frames', as a trained
    model's are its data's, made uneven: one forward of the unfolded model
    over them sets each BN's running mean to the batch mean of its
    convolution's output plus the offset x its batch std and its running
    var to the batch var x the factor, and goes on through that BN in
    eval mode.  So each layer's SiLU input is ~N(beta, gamma^2) on such
    frames, and the activations stay O(1) through the 22 layers."""
    g = torch.Generator().manual_seed(int(weights_seed))
    layers, convs = architecture(scale)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for c in convs:
        fan_in = c.cin * c.k * c.k
        if c.bn:
            p = {"w": torch.randn((c.cout, c.cin, c.k, c.k), generator=g)
                 * math.sqrt(2.0 / fan_in)}
            p["gamma"] = 0.5 + 0.5 * torch.rand((c.cout,), generator=g)
            p["beta"] = 0.1 * torch.randn((c.cout,), generator=g)
            p["dmean"] = 0.1 * torch.randn((c.cout,), generator=g)
            p["dvar"] = 0.8 + 0.4 * torch.rand((c.cout,), generator=g)
        else:
            u = torch.rand((c.cout, c.cin, c.k, c.k), generator=g)
            p = {"w": (2.0 * u - 1.0) / math.sqrt(fan_in),
                 "b": (_box_bias(int(c.name.split(".")[2]))
                       if ".cv2." in c.name
                       else torch.full((c.cout,), float(cls_bias)))}
        out[c.name] = p
    img = F.interpolate(calibration_frames(g, frame_hw)[:, None],
                        size=tuple(imgsz), mode="bilinear",
                        align_corners=False)

    def calibrate(c: ConvDef, x: torch.Tensor) -> torch.Tensor:
        p = out[c.name]
        if not c.bn:
            return F.conv2d(x, p["w"], p["b"], padding=c.k // 2)
        y = F.conv2d(x, p["w"], None, stride=c.stride, padding=c.k // 2)
        var = y.var(dim=(0, 2, 3), unbiased=False)
        p["mean"] = y.mean(dim=(0, 2, 3)) + p.pop("dmean") * torch.sqrt(var)
        p["var"] = var * p.pop("dvar")
        s = p["gamma"] / torch.sqrt(p["var"] + BN_EPS)
        return F.silu(y * s[:, None, None]
                      + (p["beta"] - p["mean"] * s)[:, None, None])

    with torch.no_grad():
        walk(layers, img.repeat(1, 3, 1, 1), calibrate)
    return out


def fold(p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A convolution with its BN folded in, as ``fuse_conv_and_bn`` does:
    kernel ``w * gamma / sqrt(var + eps)``, bias ``beta - mean * gamma /
    sqrt(var + eps)`` (float32, on the parameters' device)."""
    if "b" in p:
        return p["w"], p["b"]
    s = p["gamma"] / torch.sqrt(p["var"] + BN_EPS)
    return p["w"] * s[:, None, None, None], p["beta"] - p["mean"] * s


def walk(layers: List[tuple], x: torch.Tensor, conv) -> torch.Tensor:
    """The layers on input ``x`` (B, 3, *imgsz), each convolution through
    ``conv(ConvDef, x)``: -> Detect's per-anchor logits (B, 64 + 80, A),
    the box branch's then the class branch's, levels P3, P4, P5 in turn."""
    outs: List[torch.Tensor] = []
    for kind, _, a in layers:
        if kind == "conv":
            x = conv(a, x)
        elif kind == "c2f":
            cv1, m, cv2, shortcut = a
            y = list(conv(cv1, x).chunk(2, 1))
            for b1, b2 in m:
                h = conv(b2, conv(b1, y[-1]))
                y.append(y[-1] + h if shortcut else h)
            x = conv(cv2, torch.cat(y, 1))
        elif kind == "sppf":
            y = [conv(a[0], x)]
            for _ in range(3):
                y.append(F.max_pool2d(y[-1], 5, 1, 2))
            x = conv(a[1], torch.cat(y, 1))
        elif kind == "up":
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        elif kind == "cat":
            x = torch.cat([outs[a[0]], outs[a[1]]], 1)
        else:
            feats, box, cls = a
            levels = []
            for f, bconvs, cconvs in zip(feats, box, cls):
                bx = cx = outs[f]
                for c in bconvs:
                    bx = conv(c, bx)
                for c in cconvs:
                    cx = conv(c, cx)
                levels.append(torch.cat([bx, cx], 1).flatten(2))
            return torch.cat(levels, 2)
        outs.append(x)
    raise ValueError("the layer list does not end in Detect")


def head_output(logits: torch.Tensor, anchors: torch.Tensor,
                strides: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Detect's logits (B, 64 + 80, A) -> its inference output (B, 84, A):
    DFL (each box side's expectation over its 16 bins, in strides), then
    ``dist2bbox`` around the anchor centres (2, A) as xywh, times each
    anchor's stride (1, A); the class scores' sigmoid."""
    box_logits, cls_logits = logits.split((4 * REG_MAX, NUM_CLASSES), 1)
    B, _, A = box_logits.shape
    prob = box_logits.view(B, 4, REG_MAX, A).softmax(2)
    dist = (prob * bins[:, None]).sum(2)
    lt, rb = dist.chunk(2, 1)
    x1y1 = anchors - lt
    x2y2 = anchors + rb
    dbox = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], 1) * strides
    return torch.cat([dbox, cls_logits.sigmoid()], 1)


class YOLOv8(NamedTuple):
    """The server detector: folded parameters (``"<conv>.w"``, ``"<conv>.b"``),
    the anchors' centres (2, A) and strides (1, A) in input pixels, DFL's
    bins, and the static ``spec``.  ``forward`` and ``decode`` are what the
    fleet's slot finish calls (``core.fleet.server_ops``)."""
    params: Params
    anchors: torch.Tensor
    strides: torch.Tensor
    bins: torch.Tensor
    spec: Spec

    @property
    def conf(self) -> float:
        return self.spec.conf

    def to(self, device) -> "YOLOv8":
        return YOLOv8({k: v.to(device) for k, v in self.params.items()},
                      self.anchors.to(device), self.strides.to(device),
                      self.bins.to(device), self.spec)

    def _conv(self, c: ConvDef, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, self.params[f"{c.name}.w"], self.params[f"{c.name}.b"],
                     stride=c.stride, padding=c.k // 2)
        return F.silu(y) if c.bn else y

    def letterbox(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, H, W) in [0, 1] -> (B, 3, *imgsz): resized by the
        one factor ``imgsz`` / (H, W) (bilinear, half-pixel centres: cv2's
        INTER_LINEAR when enlarging), no padding, grey as RGB."""
        x = F.interpolate(frames[:, None], size=self.spec.imgsz,
                          mode="bilinear", align_corners=False)
        return x.repeat(1, 3, 1, 1)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, H, W) in [0, 1] -> Ultralytics' inference output (B,
        4 + 80, A): boxes xywh in input pixels, sigmoid class scores."""
        if tuple(frames.shape[-2:]) != self.spec.frame_hw:
            raise ValueError(f"frames {tuple(frames.shape)} are not "
                             f"{self.spec.frame_hw}")
        x = walk(architecture(self.spec.scale)[0], self.letterbox(frames),
                 self._conv)
        return head_output(x, self.anchors, self.strides, self.bins)

    def decode(self, raw: torch.Tensor, conf_thresh: float, k: int = 16
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
        """raw (B, 84, A) -> boxes (B, k, 4) xyxy in frame pixels, scores
        (B, k), valid (B, k), and the overflow count (0-d int64): frames
        that kept fewer than ``k`` boxes while more than ``nms_candidates``
        anchors passed ``conf_thresh``."""
        return nms_decode(raw, conf_thresh, k, self.spec)


def _check_spec(spec: Spec) -> None:
    (ih, iw), (H, W) = spec.imgsz, spec.frame_hw
    if ih * W != iw * H or ih % H or ih % STRIDES[-1] or iw % STRIDES[-1]:
        raise ValueError(f"imgsz {spec.imgsz} is not the frames {(H, W)} "
                         f"scaled by a whole factor to multiples of "
                         f"{STRIDES[-1]}")


def xywh2xyxy(b: torch.Tensor) -> torch.Tensor:
    xy, wh = b[..., :2], b[..., 2:] / 2
    return torch.cat([xy - wh, xy + wh], -1)


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, iou: float
               ) -> torch.Tensor:
    """boxes (B, n, 4) xyxy in score order, valid (B, n) -> keep (B, n):
    candidate i is kept when valid and no earlier kept candidate overlaps
    it by IoU > ``iou``."""
    over = box_iou(boxes, boxes) > iou
    keep = torch.zeros_like(valid)
    for i in range(boxes.shape[1]):
        keep[:, i] = valid[:, i] & ~(over[:, i] & keep).any(-1)
    return keep


def nms_decode(raw: torch.Tensor, conf_thresh: float, k: int, spec: Spec):
    """``YOLOv8.decode`` (see there).  Score = max over classes; the
    ``spec.nms_candidates`` best anchors by a stable descending sort;
    class-agnostic greedy NMS at ``spec.iou``; the first ``k`` kept, their
    boxes divided by the letterbox's factor and clipped to the frame, as
    Ultralytics' ``scale_boxes``."""
    B, _, A = raw.shape
    n = min(spec.nms_candidates, A)
    scores = raw[:, 4:].amax(1)
    order = torch.sort(scores, dim=1, descending=True, stable=True
                       ).indices[:, :n]
    cand_s = torch.gather(scores, 1, order)
    cand_b = torch.gather(xywh2xyxy(raw[:, :4].transpose(1, 2)), 1,
                          order[..., None].expand(B, n, 4))
    passed = scores > conf_thresh
    keep = greedy_nms(cand_b, cand_s > conf_thresh, spec.iou)
    kk = min(k, n)
    pos = torch.sort((~keep).to(torch.uint8), dim=1, stable=True
                     ).indices[:, :kk]
    (H, W), gain = spec.frame_hw, spec.imgsz[0] / spec.frame_hw[0]
    b = torch.gather(cand_b, 1, pos[..., None].expand(B, kk, 4)) / gain
    boxes = torch.stack([b[..., 0].clamp(0, W), b[..., 1].clamp(0, H),
                         b[..., 2].clamp(0, W), b[..., 3].clamp(0, H)], -1)
    overflow = ((keep.sum(1) < k) & (passed.sum(1) > n)).sum()
    return (boxes, torch.gather(cand_s, 1, pos), torch.gather(keep, 1, pos),
            overflow)


def anchors_of(imgsz: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ultralytics' ``make_anchors`` at offset 0.5, in input pixels'
    strides: centres (2, A) in strides and each anchor's stride (1, A)."""
    pts, strides = [], []
    for s in STRIDES:
        h, w = imgsz[0] // s, imgsz[1] // s
        sy, sx = torch.meshgrid(torch.arange(h, dtype=torch.float32) + 0.5,
                                torch.arange(w, dtype=torch.float32) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([sx.flatten(), sy.flatten()]))
        strides.append(torch.full((1, h * w), float(s)))
    return torch.cat(pts, 1), torch.cat(strides, 1)


def build(scale: str = "s", imgsz=(384, 640), weights_seed: int = 0,
          cls_bias: float = CLS_BIAS, iou: float = IOU, nms_candidates: int = 64,
          device=None) -> YOLOv8:
    """The detector with ``init_params``' weights folded on the CPU in
    float32, then moved to ``device``."""
    imgsz = (int(imgsz[0]), int(imgsz[1]))
    spec = Spec(scale=scale, imgsz=imgsz, iou=float(iou),
                nms_candidates=int(nms_candidates))
    _check_spec(spec)
    params: Params = {}
    for name, p in init_params(scale, imgsz, spec.frame_hw, weights_seed,
                               cls_bias).items():
        params[f"{name}.w"], params[f"{name}.b"] = fold(p)
    anchors, strides = anchors_of(imgsz)
    det = YOLOv8(params, anchors, strides,
                 torch.arange(REG_MAX, dtype=torch.float32), spec)
    return det if device is None else det.to(device)


def build_server(device, **args) -> YOLOv8:
    """The function a fleet configuration names (``detectors.server_program``
    ``"repro_torch.models.yolov8:build_server"``), called with its
    ``server_program_args``."""
    return build(device=device, **args)
