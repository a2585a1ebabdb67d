"""``yolov8s``: Ultralytics YOLOv8 at scale ``s`` as the fleet's server
detector, in plain torch.

The layers are ``ultralytics/cfg/models/v8/yolov8.yaml`` at scale ``s``
(depth 0.33, width 0.50, max channels 1024): Conv = Conv2d (no bias,
padding k // 2) + BatchNorm (eps 1e-3) + SiLU; C2f = a 1 x 1 Conv to 2c,
split in two, n Bottlenecks (two 3 x 3 Convs, a residual where shortcut
is set) on the last part, all parts joined, a 1 x 1 Conv; SPPF = a 1 x 1
Conv to c/2, three chained 5 x 5 max pools at stride 1, joined, a 1 x 1
Conv; the PAN neck's nearest x 2 upsampling and concatenations; the
decoupled anchor-free Detect head at strides 8, 16 and 32 (box branch
Conv 64, Conv 64, 1 x 1 to 4 x 16; class branch Conv 128, Conv 128, 1 x
1 to 80), its DFL (softmax over 16 bins times their index) and
``dist2bbox`` around the anchor centres (x + 0.5, y + 0.5) x stride, the
class scores' sigmoid.  11,166,544 learnable parameters; 28.6 GFLOPs at
640 x 640 (``flops``).

Where it departs from the published model, as the program does:

- the grey frames are repeated to three channels;
- the letterbox is a plain x ``imgsz`` / frame resize (bilinear, half-pixel
  centres): the configuration's ``imgsz`` is the frame scaled by one
  whole factor to multiples of 32, so there is no padding;
- each BatchNorm is folded into its convolution at load (Ultralytics'
  ``fuse_conv_and_bn``), in float32 on the CPU;
- the NMS is class-agnostic (the scene's ground truth has no classes),
  over the ``nms_candidates`` (64) best anchors by score (a stable sort),
  and the first ``k`` (16) kept boxes are the detections; Ultralytics'
  confidence (0.25) and IoU (0.7) defaults are the configuration's
  ``control.server_conf_thresh`` and ``server_program_args.iou``;
- the weights are seeded random (no trained weights are in the
  repository), drawn by ``weights``' recipe from ``weights_seed``, with
  the class branch's last bias the configuration's ``cls_bias``.

It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.detectors.conv4 import box_iou

NC, REG_MAX, STRIDES, EPS = 80, 16, (8, 16, 32), 1e-3
DEPTH, WIDTH, MAX_CH = 0.33, 0.50, 1024
# each level's DFL peak of the box branch's last bias, in strides
BOX_BINS = (3.0, 2.0, 1.25)


def ch(c: int) -> int:
    return int(math.ceil(min(c, MAX_CH) * WIDTH / 8) * 8)


def depth(n: int) -> int:
    return max(round(n * DEPTH), 1)


def conv_table() -> List[Tuple[str, int, int, int, bool]]:
    """(name, in, out, kernel, has BN) of every convolution in the order
    of the yaml's layers (inside C2f: cv1, the bottlenecks, cv2; Detect's
    box branches, then its class branches): the order the weights are
    drawn in."""
    t: List[Tuple[str, int, int, int, bool]] = []

    def c2f(i, cin, cout, n):
        c = cout // 2
        t.append((f"{i}.cv1", cin, 2 * c, 1, True))
        for j in range(n):
            t.append((f"{i}.m.{j}.cv1", c, c, 3, True))
            t.append((f"{i}.m.{j}.cv2", c, c, 3, True))
        t.append((f"{i}.cv2", (2 + n) * c, cout, 1, True))

    t += [("0", 3, ch(64), 3, True), ("1", ch(64), ch(128), 3, True)]
    c2f(2, ch(128), ch(128), depth(3))
    t.append(("3", ch(128), ch(256), 3, True))
    c2f(4, ch(256), ch(256), depth(6))
    t.append(("5", ch(256), ch(512), 3, True))
    c2f(6, ch(512), ch(512), depth(6))
    t.append(("7", ch(512), ch(1024), 3, True))
    c2f(8, ch(1024), ch(1024), depth(3))
    t += [("9.cv1", ch(1024), ch(1024) // 2, 1, True),
          ("9.cv2", 2 * ch(1024), ch(1024), 1, True)]
    c2f(12, ch(1024) + ch(512), ch(512), depth(3))
    c2f(15, ch(512) + ch(256), ch(256), depth(3))
    t.append(("16", ch(256), ch(256), 3, True))
    c2f(18, ch(256) + ch(512), ch(512), depth(3))
    t.append(("19", ch(512), ch(512), 3, True))
    c2f(21, ch(512) + ch(1024), ch(1024), depth(3))
    feat = (ch(256), ch(512), ch(1024))
    c2, c3 = max(16, feat[0] // 4, 4 * REG_MAX), max(feat[0], min(NC, 100))
    for i, f in enumerate(feat):
        t += [(f"22.cv2.{i}.0", f, c2, 3, True), (f"22.cv2.{i}.1", c2, c2, 3, True),
              (f"22.cv2.{i}.2", c2, 4 * REG_MAX, 1, False)]
    for i, f in enumerate(feat):
        t += [(f"22.cv3.{i}.0", f, c3, 3, True), (f"22.cv3.{i}.1", c3, c3, 3, True),
              (f"22.cv3.{i}.2", c3, NC, 1, False)]
    return t


# the stride-2 convolutions, and the head's last ones (no BN, no SiLU)
DOWN = {"0", "1", "3", "5", "7", "16", "19"}
LAST = {name for name, *_, bn in conv_table() if not bn}


def layers(x: torch.Tensor, conv) -> torch.Tensor:
    """The model on input ``x`` (B, 3, H, W), each convolution through
    ``conv(name, x)``: -> Detect's logits (B, 64 + 80, A), levels P3, P4,
    P5 in turn."""
    def c2f(i, x, n, shortcut):
        y = list(conv(f"{i}.cv1", x).chunk(2, 1))
        for j in range(n):
            h = conv(f"{i}.m.{j}.cv2", conv(f"{i}.m.{j}.cv1", y[-1]))
            y.append(y[-1] + h if shortcut else h)
        return conv(f"{i}.cv2", torch.cat(y, 1))

    def up(x):
        return F.interpolate(x, scale_factor=2.0, mode="nearest")

    x = conv("1", conv("0", x))
    x = c2f(2, x, depth(3), True)
    p3 = c2f(4, conv("3", x), depth(6), True)
    p4 = c2f(6, conv("5", p3), depth(6), True)
    x = c2f(8, conv("7", p4), depth(3), True)
    y = [conv("9.cv1", x)]
    for _ in range(3):
        y.append(F.max_pool2d(y[-1], 5, 1, 2))
    p5 = conv("9.cv2", torch.cat(y, 1))
    h12 = c2f(12, torch.cat([up(p5), p4], 1), depth(3), False)
    h15 = c2f(15, torch.cat([up(h12), p3], 1), depth(3), False)
    h18 = c2f(18, torch.cat([conv("16", h15), h12], 1), depth(3), False)
    h21 = c2f(21, torch.cat([conv("19", h18), p5], 1), depth(3), False)
    out = []
    for i, f in enumerate((h15, h18, h21)):
        b, c = f, f
        for j in range(3):
            b = conv(f"22.cv2.{i}.{j}", b)
            c = conv(f"22.cv3.{i}.{j}", c)
        out.append(torch.cat([b, c], 1).flatten(2))
    return torch.cat(out, 2)


def calibration_frames(g: torch.Generator, H: int, W: int) -> torch.Tensor:
    """Two frames like the scene's, from ``g``: 8 x 8 blocks of
    U(0.25, 0.55), eight rectangles of 8-25 pixels at U(0.6, 1) (each
    rectangle's x, y, w, h and value from 5 uniforms), N(0, 0.06^2) noise
    (about the codec's on the frames served), clipped to [0, 1]."""
    frames = []
    for _ in range(2):
        b = 0.25 + 0.3 * torch.rand((-(-H // 8), -(-W // 8)), generator=g)
        f = b.repeat_interleave(8, 0).repeat_interleave(8, 1)[:H, :W].clone()
        for u in torch.rand((8, 5), generator=g).tolist():
            w, h = 8 + int(18 * u[2]), 8 + int(18 * u[3])
            x, y = int((W - w) * u[0]), int((H - h) * u[1])
            f[y:y + h, x:x + w] = 0.6 + 0.4 * u[4]
        frames.append((f + 0.06 * torch.randn((H, W), generator=g))
                      .clamp(0, 1))
    return torch.stack(frames)


def weights(seed: int, cls_bias: float, imgsz: Tuple[int, int],
            frame_hw: Tuple[int, int]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The seeded weights, BN unfolded, float32 on the CPU.  From one
    ``torch.Generator().manual_seed(seed)``, convolution by convolution in
    ``conv_table`` order: a BN convolution's kernel ``randn x sqrt(2 /
    fan_in)`` (Kaiming normal), gamma ``0.5 + 0.5 rand``, beta ``0.1
    randn``, a mean offset ``0.1 randn`` and a variance factor ``0.8 + 0.4
    rand``; a head's last convolution's kernel ``U(-1, 1) / sqrt(fan_in)``
    (PyTorch's default) and its bias: the box branch's each side's 16
    logits ``-(j - BOX_BINS[level])^2 / 2``, the class branch's
    ``cls_bias``.  Then ``calibration_frames``, resized to ``imgsz`` as the
    input is, run through the model with BN in eval mode: each BN's
    running mean is its convolution's batch mean plus the offset x the
    batch std, its running var the batch var x the factor."""
    g = torch.Generator().manual_seed(int(seed))
    p: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, cin, cout, k, bn in conv_table():
        fan = cin * k * k
        if bn:
            p[name] = {
                "w": torch.randn((cout, cin, k, k), generator=g)
                * math.sqrt(2.0 / fan),
                "gamma": 0.5 + 0.5 * torch.rand((cout,), generator=g),
                "beta": 0.1 * torch.randn((cout,), generator=g),
                "dmean": 0.1 * torch.randn((cout,), generator=g),
                "dvar": 0.8 + 0.4 * torch.rand((cout,), generator=g)}
            continue
        w = (2.0 * torch.rand((cout, cin, k, k), generator=g) - 1.0) \
            / math.sqrt(fan)
        if ".cv2." in name:
            j = torch.arange(REG_MAX, dtype=torch.float32)
            b = (-0.5 * (j - BOX_BINS[int(name.split(".")[2])]) ** 2
                 ).repeat(4)
        else:
            b = torch.full((cout,), float(cls_bias))
        p[name] = {"w": w, "b": b}
    img = F.interpolate(calibration_frames(g, *frame_hw)[:, None],
                        size=tuple(imgsz), mode="bilinear",
                        align_corners=False)

    def conv(name, x):
        q = p[name]
        pad = q["w"].shape[-1] // 2
        if "b" in q:
            return F.conv2d(x, q["w"], q["b"], padding=pad)
        y = F.conv2d(x, q["w"], None, stride=2 if name in DOWN else 1,
                     padding=pad)
        var = y.var(dim=(0, 2, 3), unbiased=False)
        q["mean"] = y.mean(dim=(0, 2, 3)) + q.pop("dmean") * torch.sqrt(var)
        q["var"] = var * q.pop("dvar")
        s = q["gamma"] / torch.sqrt(q["var"] + EPS)
        return F.silu(y * s[:, None, None]
                      + (q["beta"] - q["mean"] * s)[:, None, None])

    with torch.no_grad():
        layers(img.repeat(1, 3, 1, 1), conv)
    return p


class Raw(NamedTuple):
    """``forward``'s output: Ultralytics' inference output ``out`` (B, 84,
    A), boxes xywh in input pixels and sigmoid class scores, float32; and
    what ``decode`` reads of the configuration."""
    out: torch.Tensor
    iou: float
    candidates: int
    gain: float
    frame_hw: Tuple[int, int]


# -- the server detector's interface (see ``__init__``) ------------------------

def load(config: Dict, weights_dir, device):
    """The folded parameters of ``detectors.server_program_args``
    (``weights_dir`` unused: the weights are drawn, not read), with the
    anchors and the decode's settings."""
    a = config["detectors"]["server_program_args"]
    if a.get("scale", "s") != "s":
        raise ValueError(f"this reference is scale 's', not {a['scale']!r}")
    imgsz = (int(a["imgsz"][0]), int(a["imgsz"][1]))
    frame_hw = (int(config["scene"]["height"]), int(config["scene"]["width"]))
    params = {}
    for name, q in weights(a["weights_seed"], a["cls_bias"], imgsz,
                           frame_hw).items():
        if "b" in q:
            params[name] = (q["w"], q["b"])
        else:
            s = q["gamma"] / torch.sqrt(q["var"] + EPS)
            params[name] = (q["w"] * s[:, None, None, None],
                            q["beta"] - q["mean"] * s)
    pts, strides = [], []
    for s in STRIDES:
        h, w = imgsz[0] // s, imgsz[1] // s
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32) + 0.5,
                                torch.arange(w, dtype=torch.float32) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([xx.flatten(), yy.flatten()]))
        strides.append(torch.full((1, h * w), float(s)))
    dev = torch.device(device)
    return {"convs": {k: (w.to(dev), b.to(dev)) for k, (w, b)
                      in params.items()},
            "anchors": torch.cat(pts, 1).to(dev),
            "strides": torch.cat(strides, 1).to(dev),
            "bins": torch.arange(REG_MAX, dtype=torch.float32).to(dev),
            "imgsz": imgsz, "frame_hw": frame_hw,
            "iou": float(a["iou"]),
            "candidates": int(a["nms_candidates"])}


def forward(params, frames: torch.Tensor, dtype: torch.dtype) -> Raw:
    """frames (B, H, W) in [0, 1] -> ``Raw``, every layer computed in
    ``dtype``."""
    convs = {k: (w.to(dtype), b.to(dtype))
             for k, (w, b) in params["convs"].items()}

    def conv(name, x):
        w, b = convs[name]
        y = F.conv2d(x, w, b, stride=2 if name in DOWN else 1,
                     padding=w.shape[-1] // 2)
        return y if name in LAST else F.silu(y)

    x = F.interpolate(frames[:, None].to(dtype), size=params["imgsz"],
                      mode="bilinear", align_corners=False)
    y = layers(x.repeat(1, 3, 1, 1), conv)
    box, cls = y.split((4 * REG_MAX, NC), 1)
    B, _, A = box.shape
    dist = (box.view(B, 4, REG_MAX, A).softmax(2)
            * params["bins"].to(dtype)[:, None]).sum(2)
    lt, rb = dist.chunk(2, 1)
    anchors = params["anchors"].to(dtype)
    x1y1, x2y2 = anchors - lt, anchors + rb
    dbox = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], 1) \
        * params["strides"].to(dtype)
    out = torch.cat([dbox, cls.sigmoid()], 1).to(torch.float32)
    return Raw(out, params["iou"], params["candidates"],
               params["imgsz"][0] / params["frame_hw"][0], params["frame_hw"])


def decode(raw: Raw, conf_thresh: float, k: int = 16):
    """-> boxes (B, k, 4) xyxy in frame pixels, scores (B, k), valid (B,
    k): score = max over the classes; the ``candidates`` best anchors by a
    stable descending sort; greedy NMS (a candidate is kept when it passes
    ``conf_thresh`` and overlaps no earlier kept one by IoU > ``iou``);
    the first ``k`` kept, divided by the letterbox's factor and clipped to
    the frame."""
    out = raw.out
    B, _, A = out.shape
    n = min(raw.candidates, A)
    scores = out[:, 4:].amax(1)
    order = torch.sort(scores, dim=1, descending=True, stable=True
                       ).indices[:, :n]
    s = torch.gather(scores, 1, order)
    xywh = out[:, :4].transpose(1, 2)
    xy, half = xywh[..., :2], xywh[..., 2:] / 2
    boxes = torch.gather(torch.cat([xy - half, xy + half], -1), 1,
                         order[..., None].expand(B, n, 4))
    over = box_iou(boxes, boxes) > raw.iou
    valid = s > conf_thresh
    keep = torch.zeros_like(valid)
    for i in range(n):
        keep[:, i] = valid[:, i] & ~(over[:, i] & keep).any(-1)
    kk = min(k, n)
    pos = torch.sort((~keep).to(torch.uint8), dim=1, stable=True
                     ).indices[:, :kk]
    b = torch.gather(boxes, 1, pos[..., None].expand(B, kk, 4)) / raw.gain
    H, W = raw.frame_hw
    b = torch.stack([b[..., 0].clamp(0, W), b[..., 1].clamp(0, H),
                     b[..., 2].clamp(0, W), b[..., 3].clamp(0, H)], -1)
    return b, torch.gather(s, 1, pos), torch.gather(keep, 1, pos)


def flops(config: Dict) -> int:
    """One frame at ``server_program_args.imgsz``: 2 x the multiply-adds of
    every convolution (Ultralytics' count: 28,601,548,800 at 640 x 640,
    17,160,929,280 at 384 x 640)."""
    h, w = config["detectors"]["server_program_args"]["imgsz"]
    # each convolution's output stride: a layer's maps are the input / 2^k
    level = {"0": 2, "1": 4, "2": 4, "3": 8, "4": 8, "5": 16, "6": 16,
             "7": 32, "8": 32, "9": 32, "12": 16, "15": 8, "16": 16,
             "18": 16, "19": 32, "21": 32}
    total = 0
    for name, cin, cout, k, _ in conv_table():
        top = name.split(".")
        s = STRIDES[int(top[2])] if top[0] == "22" else level[top[0]]
        total += cout * cin * k * k * (h // s) * (w // s)
    return 2 * total
