"""Plain reference of the DeepStream fleet's slot path, for the benchmark.

A frozen copy, in plain PyTorch and numpy, of what one slot of the
``deepstream`` method computes in ``repro_torch``'s reference body: scene
synthesis (``DeviceScene``), ROIDet (light detector, edge motion,
connected components, box union), control (elastic update, utility MLP,
knapsack DP), encode (the codec's blur, quantisation and noise) and finish
(server detector, box decode, greedy F1).  It imports nothing of the
program: no CUDA graph, no hand-written kernel (each kernel's plain
version is written out here), no pipelining, no camera mesh.  Every
operation runs in the order of the program's eager reference body, so on
one device and in one precision the two give the same logs.

Everything the program derives is worked out again here from the same
inputs: the scene geometry from the seed, the threefry keys and draws, the
utility MLP from ``PRNGKey(0)``, the codec tables and the DP capacity.
The detector weights are read from the committed checkpoint files, which
both sides read.

``detector_dtype`` is the precision of the two detectors' convolutions:
float32 (what the configuration states) or, for the benchmark's control,
bfloat16.
"""
from __future__ import annotations

import json
import math
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# -- threefry2x32 keys and draws (jax.random's bits) --------------------------

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for g in range(5):
        for r in _ROT[g % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(g + 1) % 3]) & MASK
        b = (b + ks[(g + 2) % 3] + (g + 1)) & MASK
    return a, b


def prng_key(seed: int, device) -> torch.Tensor:
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must be a uint32 value, got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    if torch.is_tensor(data):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
        x1 = torch.zeros_like(d)
    else:
        d, x1 = int(data) & MASK, 0
    a, b = threefry2x32(key[..., 0], key[..., 1], x1, d)
    return torch.stack([a, b], dim=-1)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    hi, lo = _counters(num, key.device)
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    hi, lo = _counters(n, key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return (a ^ b).reshape(key.shape[:-1] + shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def uniform(key, shape, minval: float, maxval: float) -> torch.Tensor:
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = _f32(minval)
    span = float(np.float32(maxval) - np.float32(lo))
    return torch.clamp(floats * span + lo, min=lo)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64)."""
    return torch.sqrt(x.double()).float()


def fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add through one float64 add."""
    a = a.double()
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


_LOG_P = tuple(_f32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
SQRT2 = _f32(math.sqrt(2.0))


def log(v: torch.Tensor) -> torch.Tensor:
    """float32 natural log as XLA's CPU backend expands it (Cephes)."""
    v = torch.clamp(v, min=_f32(1.17549435e-38))
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _f32(0.707106781186547524)
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    x2 = m * m
    x3 = x2 * m
    y = fma(m, _LOG_P[0], _LOG_P[1])
    y1 = fma(m, _LOG_P[3], _LOG_P[4])
    y2 = fma(m, _LOG_P[6], _LOG_P[7])
    y = fma(y, m, _LOG_P[2])
    y1 = fma(y1, m, _LOG_P[5])
    y2 = fma(y2, m, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    m = fma(x2, -0.5, m)
    return fma(e, _LOG_Q2, m + y)


def _horner(x, coeffs):
    r = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        r = fma(r, x, _f32(c))
    return r


def log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    s = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    s = fma(x2, -0.5, (x * x2) * s)
    small = x.abs() < _f32(0.41421356237309504880)
    return torch.where(small, x + s, log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -log1p(x * (-x))
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0]), _f32(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, ww, torch.where(lt, _f32(c_lt), _f32(c_ge)))
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal_erfinv(key, shape) -> torch.Tensor:
    return erf_inv(uniform(key, shape, _LO, 1.0))


def normal(key, shape) -> torch.Tensor:
    return normal_erfinv(key, shape) * SQRT2


# -- configuration -------------------------------------------------------------

@dataclass(frozen=True)
class FleetSpec:
    """The settings of one fleet configuration file that the slot reads."""
    num_cameras: int
    height: int
    width: int
    fps: int
    seg_seconds: float
    max_objects: int
    spawn_rate: float
    mean_speed: float
    obj_size_range: Tuple[int, int]
    num_stationary: int
    view_jitter: float
    cam_lag_frames: int
    noise_std: float
    eval_frames: int
    block_size: int
    w_cap_kbps: float
    bitrates: Tuple[int, ...]
    resolutions: Tuple[float, ...]
    slot_seconds: float
    temporal_rho: float
    sigma0: float
    beta: float
    quant_scale: float
    alpha: float
    gamma_a: float
    gamma_wl: float
    budget_kbits: float
    tau_wl: float
    tau_wh: float
    mlp_seed: int
    run_key_seed: int
    conf_thresh_server: float

    @property
    def frames(self) -> int:
        return int(self.fps * self.seg_seconds)

    @classmethod
    def of(cls, cfg: Dict) -> "FleetSpec":
        sc, sy, co, el = (cfg["scene"], cfg["system"], cfg["codec"],
                          cfg["elastic"])
        return cls(
            num_cameras=int(sc["num_cameras"]), height=int(sc["height"]),
            width=int(sc["width"]), fps=int(sc["fps"]),
            seg_seconds=float(sc["seg_seconds"]),
            max_objects=int(sc["max_objects"]),
            spawn_rate=float(sc["spawn_rate"]),
            mean_speed=float(sc["mean_speed"]),
            obj_size_range=tuple(int(v) for v in sc["obj_size_range"]),
            num_stationary=int(sc["num_stationary"]),
            view_jitter=float(sc["view_jitter"]),
            cam_lag_frames=int(sc["cam_lag_frames"]),
            noise_std=float(sc["noise_std"]),
            eval_frames=int(sy["eval_frames"]),
            block_size=int(sy["block_size"]),
            w_cap_kbps=float(sy["w_cap_kbps"]),
            bitrates=tuple(int(b) for b in co["bitrates_kbps"]),
            resolutions=tuple(float(r) for r in co["resolutions"]),
            slot_seconds=float(co["slot_seconds"]),
            temporal_rho=float(co["temporal_rho"]),
            sigma0=float(co["sigma0"]), beta=float(co["beta"]),
            quant_scale=float(co["quant_scale"]),
            alpha=float(el["alpha"]), gamma_a=float(el["gamma_a"]),
            gamma_wl=float(el["gamma_wl"]),
            budget_kbits=float(el["budget_kbits"]),
            tau_wl=float(cfg["control"]["tau_wl_kbps"]),
            tau_wh=float(cfg["control"]["tau_wh_kbps"]),
            mlp_seed=int(cfg["control"]["utility_mlp_seed"]),
            run_key_seed=int(cfg["control"]["run_key_seed"]),
            conf_thresh_server=float(cfg["control"]["server_conf_thresh"]))


# -- scene synthesis ---------------------------------------------------------

class Scene(NamedTuple):
    backgrounds: torch.Tensor
    stat_boxes: torch.Tensor
    stat_valid: torch.Tensor
    offsets: torch.Tensor
    lags: torch.Tensor
    cam_ids: torch.Tensor
    objects: torch.Tensor


def init_scene(spec: FleetSpec, seed: int, device) -> Scene:
    """The scene geometry, drawn with numpy from the seed in the order the
    JAX package draws it."""
    rng = np.random.default_rng(seed)
    C, H, W = spec.num_cameras, spec.height, spec.width
    backgrounds = np.zeros((C, H, W), np.float32)
    for i in range(C):
        base = rng.uniform(0.25, 0.55, (H // 8, W // 8))
        backgrounds[i] = np.kron(base, np.ones((8, 8)))[:H, :W]
    offsets = rng.uniform(-spec.view_jitter, spec.view_jitter, (C, 2))
    lags = rng.integers(0, spec.cam_lag_frames + 1, C)
    S = spec.num_stationary
    stat_boxes = np.zeros((C, S, 4), np.float32)
    for i in range(C):
        for s in range(S):
            w = int(rng.integers(*spec.obj_size_range))
            h = int(rng.integers(*spec.obj_size_range))
            x = int(rng.integers(0, W - w))
            y = int(rng.integers(0, H - h))
            v = float(rng.uniform(0.7, 0.95))
            backgrounds[i, y:y + h, x:x + w] = v
            stat_boxes[i, s] = (x, y, x + w, y + h)
    K = spec.max_objects
    period = rng.integers(140, 320, K).astype(np.float32)
    objects = np.stack([
        rng.integers(0, 2, K).astype(np.float32),
        np.maximum(0.5, rng.normal(spec.mean_speed, 1.0, K)),
        rng.uniform(0.15, 0.85, K) * H,
        rng.normal(0, 0.2, K),
        rng.integers(*spec.obj_size_range, K).astype(np.float32),
        rng.integers(*spec.obj_size_range, K).astype(np.float32),
        rng.uniform(0.6, 1.0, K),
        rng.uniform(0, period),
        period,
        np.minimum(rng.integers(60, 240, K), period - 30),
    ], axis=1).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                     device=device)
    return Scene(backgrounds=t(backgrounds), stat_boxes=t(stat_boxes),
                 stat_valid=torch.ones((C, S), dtype=torch.bool,
                                       device=device),
                 offsets=t(offsets.astype(np.float32)),
                 lags=t(lags, torch.int32),
                 cam_ids=torch.arange(C, dtype=torch.int32, device=device),
                 objects=t(objects))


def gt_capacity(spec: FleetSpec) -> int:
    n = spec.max_objects + spec.num_stationary
    return max(-(-n // 8) * 8, 16)


def segment(spec: FleetSpec, sc: Scene, key: torch.Tensor, t: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot t (a 0-d int64 tensor) -> (frames (C, N, H, W), gt_boxes
    (C, N, G, 4), gt_valid)."""
    C = sc.backgrounds.shape[0]
    N, H, W = spec.frames, spec.height, spec.width
    K, S = sc.objects.shape[0], sc.stat_boxes.shape[1]
    G = gt_capacity(spec)
    dev = sc.backgrounds.device
    f = torch.arange(N, dtype=torch.int32, device=dev)
    g = torch.clamp(t * N + f[None, :] - sc.lags[:, None], min=0)
    gf = g.to(torch.float32)[None]
    o = sc.objects
    side, speed, y0, vy, w_o, h_o, val, phase, period, ttl = (
        o[:, i, None, None] for i in range(10))
    u = torch.remainder(gf + phase, period)
    active = u < ttl
    x = torch.where(side > 0.5, fma(-speed, u, W + 20.0),
                    fma(speed, u, -20.0))
    y = fma(vy, u, y0)
    ox = sc.offsets[None, :, 0, None]
    oy = sc.offsets[None, :, 1, None]
    x0 = torch.round(x + ox)
    y0_ = torch.round(y + oy)
    cx0 = torch.clamp(x0, 0, W)
    cy0 = torch.clamp(y0_, 0, H)
    cx1 = torch.clamp(x0 + w_o, 0, W)
    cy1 = torch.clamp(y0_ + h_o, 0, H)
    ok = active & (cx1 - cx0 >= 3) & (cy1 - cy0 >= 3)
    frames = sc.backgrounds[:, None].expand(C, N, H, W).reshape(
        C * N, H, W).clone()
    PW = -(-(int(spec.obj_size_range[1]) + 1) // 8) * 8
    win = torch.arange(PW, dtype=torch.float32, device=dev)
    win_i = torch.arange(PW, dtype=torch.int64, device=dev)
    b_idx = torch.arange(C * N, device=dev)[:, None, None]
    for k in range(K):
        cx0k, cx1k = cx0[k].reshape(-1), cx1[k].reshape(-1)
        cy0k, cy1k = cy0[k].reshape(-1), cy1[k].reshape(-1)
        x0k = torch.clamp(cx0k, 0, W - PW)
        y0k = torch.clamp(cy0k, 0, H - PW)
        ys0 = cy0k + torch.floor((cy1k - cy0k) / 3.0)
        ys1 = cy0k + torch.floor((cy1k - cy0k) / 2.0)
        rows = y0k.to(torch.int64)[:, None, None] + win_i[None, :, None]
        cols = x0k.to(torch.int64)[:, None, None] + win_i[None, None, :]
        patch = frames[b_idx, rows, cols]
        pr = (y0k[:, None] + win)[:, :, None]
        pc = (x0k[:, None] + win)[:, None, :]
        in_c = ((pc >= cx0k[:, None, None]) & (pc < cx1k[:, None, None])
                & ok[k].reshape(-1)[:, None, None])
        body = in_c & (pr >= cy0k[:, None, None]) & (pr < cy1k[:, None, None])
        stripe = in_c & (pr >= ys0[:, None, None]) & (pr < ys1[:, None, None])
        v = val[k, 0, 0]
        patch = torch.where(body, v, patch)
        patch = torch.where(stripe, v * 0.6, patch)
        frames[b_idx, rows, cols] = patch
    frames = frames.reshape(C, N, H, W)
    kt = fold_in(key, t)
    e = normal_erfinv(fold_in(kt, sc.cam_ids.to(torch.int64)), (N, H, W))
    scale = float(np.float32(spec.noise_std) * np.float32(SQRT2))
    frames = torch.clamp(fma(e, scale, frames), 0.0, 1.0)
    mov_boxes = torch.stack([cx0, cy0, cx1, cy1], dim=-1).permute(1, 2, 0, 3)
    mov_valid = ok.permute(1, 2, 0)
    gt_boxes = torch.cat(
        [sc.stat_boxes[:, None].expand(C, N, S, 4), mov_boxes], dim=2)
    gt_valid = torch.cat(
        [sc.stat_valid[:, None].expand(C, N, S), mov_valid], dim=2)
    gt_boxes = torch.where(gt_valid[..., None], gt_boxes, 0.0)
    if G > S + K:
        pad = G - S - K
        gt_boxes = torch.cat([gt_boxes, gt_boxes.new_zeros(C, N, pad, 4)], 2)
        gt_valid = torch.cat([gt_valid, gt_valid.new_zeros(C, N, pad)], 2)
    return frames, gt_boxes.contiguous(), gt_valid.contiguous()


# -- detectors ---------------------------------------------------------------

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


def f1_score_batch(pred_boxes, pred_valid, gt_boxes, gt_valid,
                   iou_thresh: float = 0.3):
    """Greedy one-to-one F1 per frame."""
    B, K = pred_valid.shape
    G = gt_valid.shape[1]
    dev = pred_boxes.device
    iou = box_iou(pred_boxes, gt_boxes)
    pair_ok = pred_valid[:, :, None] & gt_valid[:, None, :]
    iou_m = torch.where(pair_ok, iou, -1.0)
    order = torch.sort(-iou_m.max(dim=2).values, dim=1, stable=True).indices
    bi = torch.arange(B, device=dev)
    matched = torch.zeros((B, G), dtype=torch.bool, device=dev)
    tp = torch.zeros((B,), dtype=torch.int32, device=dev)
    for p in range(K):
        i = order[:, p]
        row = iou_m[bi, i]
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


# -- ROIDet: edge motion, connected components, box union ---------------------

MOTION_THRESH = 16.0
EDGE_THRESH = 0.35
ROI_CONF_THRESH = 0.25
MAX_BOXES = 16
LABEL_INF = 2 ** 30


def segment_motion(frames, *, block_size: int, edge_thresh: float):
    """frames (C, M, H, W) -> (C, M-1, H/bs, W/bs): per consecutive pair,
    the XOR of the squared-Sobel edge maps summed over blocks."""
    C, M, H, W = frames.shape
    bs = block_size
    x = F.pad(frames.reshape(-1, 1, H, W), (1, 1, 1, 1),
              mode="replicate")[:, 0]
    tl, tc, tr = x[:, :-2, :-2], x[:, :-2, 1:-1], x[:, :-2, 2:]
    ml, mr = x[:, 1:-1, :-2], x[:, 1:-1, 2:]
    bl, bc, br = x[:, 2:, :-2], x[:, 2:, 1:-1], x[:, 2:, 2:]
    gx = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    gy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    mag2 = (gx * gx + gy * gy).reshape(C, M, H, W)
    e = mag2 > float(np.float32(edge_thresh * edge_thresh))
    d = (e[:, :-1] ^ e[:, 1:]).to(torch.float32)
    return d.reshape(C, M - 1, H // bs, bs, W // bs, bs).sum(dim=(3, 5))


def cc_labels(mask: torch.Tensor) -> torch.Tensor:
    """mask (C, M, N) bool -> each component's least row-major cell index,
    LABEL_INF on the background (min-label propagation to the
    fixpoint)."""
    C, M, N = mask.shape
    idx = torch.arange(M * N, dtype=torch.int32,
                       device=mask.device).reshape(1, M, N)
    labels = torch.where(mask, idx, LABEL_INF)
    for _ in range(M * N):
        p = F.pad(labels, (1, 1, 1, 1), value=LABEL_INF)
        neigh = torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                              torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))
        new = torch.where(mask, torch.minimum(labels, neigh), LABEL_INF)
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def label_and_boxes(mask: torch.Tensor, max_boxes: int):
    C, M, N = mask.shape
    dev = mask.device
    labels = cc_labels(mask)
    flat = labels.reshape(C, -1).to(torch.int64)
    num_seg = M * N + 1
    seg = torch.where(flat == LABEL_INF, M * N, flat)
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
    return boxes, valid


def _boxes_to_mask(boxes, valid, M: int, N: int, scale: float = 1.0):
    dev = boxes.device
    rows = torch.arange(M, device=dev, dtype=torch.float32)[:, None]
    cols = torch.arange(N, device=dev, dtype=torch.float32)[None, :]
    x0, y0, x1, y1 = (boxes[..., j].to(torch.float32)[..., None, None] * scale
                      for j in range(4))
    m = ((rows >= torch.floor(y0)) & (rows < torch.ceil(y1))
         & (cols >= torch.floor(x0)) & (cols < torch.ceil(x1)))
    return torch.any(m & valid[..., None, None], dim=1)


def roidet(frames, light, block_size: int, dtype: torch.dtype):
    """frames (C, N, H, W) -> (ROI block masks (C, M, Nb), area ratio a (C,),
    mean detection confidence c (C,))."""
    C = frames.shape[0]
    grid = detector_forward(light, torch.cat([frames[:, 0], frames[:, -1]]),
                            dtype)
    b2, s2, v2 = decode_boxes(grid, conf_thresh=ROI_CONF_THRESH)
    dboxes = torch.cat([b2[:C], b2[C:]], dim=1)
    dscores = torch.cat([s2[:C], s2[C:]], dim=1)
    dvalid = torch.cat([v2[:C], v2[C:]], dim=1)
    conf = (torch.where(dvalid, dscores, 0.0).sum(dim=1)
            / torch.clamp(dvalid.sum(dim=1), min=1))
    scores = segment_motion(frames, block_size=block_size,
                            edge_thresh=EDGE_THRESH)
    D = torch.any(scores > MOTION_THRESH, dim=1)
    _, M, N = D.shape
    mboxes, mvalid = label_and_boxes(D, MAX_BOXES)
    mask = (_boxes_to_mask(mboxes, mvalid, M, N)
            | _boxes_to_mask(dboxes, dvalid, M, N, scale=1.0 / block_size))
    p = F.pad(mask, (1, 1, 1, 1))
    mask = (p[:, 1:-1, 1:-1] | p[:, :-2, 1:-1] | p[:, 2:, 1:-1]
            | p[:, 1:-1, :-2] | p[:, 1:-1, 2:])
    area = mask.to(torch.float32).sum(dim=(1, 2)) / float(M * N)
    return mask, area, conf


# -- control: elastic update, utility MLP, knapsack DP -------------------------

class Elastic(NamedTuple):
    a_ema: torch.Tensor
    a_var: torch.Tensor
    debt_kbits: torch.Tensor
    initialized: torch.Tensor


def elastic_init(device) -> Elastic:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return Elastic(z, z, z, torch.zeros((), dtype=torch.bool, device=device))


def elastic_update(spec: FleetSpec, st: Elastic, total_area, W_kbps, tau_wl,
                   tau_wh, reset_debt) -> Tuple[Elastic, torch.Tensor]:
    """One slot of the elastic mechanism: (new state, extra Kbit)."""
    debt0 = torch.where(reset_debt, 0.0, st.debt_kbits)
    sigma_a = sqrt(torch.clamp(st.a_var, min=1e-12))
    tau_a = st.a_ema + spec.gamma_a * sigma_a
    borrow = (total_area > tau_a) & (W_kbps < tau_wl)
    headroom = torch.clamp(spec.budget_kbits - debt0, min=0.0)
    borrowed = torch.where(
        borrow, torch.minimum(spec.gamma_wl * (tau_wl - W_kbps)
                              * spec.slot_seconds, headroom), 0.0)
    repay = ~borrow & (W_kbps >= tau_wh) & (debt0 > 0.0)
    repaid = torch.where(
        repay, torch.minimum(debt0, (W_kbps - tau_wh) * spec.slot_seconds),
        0.0)
    debt = debt0 + borrowed - repaid
    delta = total_area - st.a_ema
    a_ema = st.a_ema + spec.alpha * delta
    a_var = (1 - spec.alpha) * (st.a_var + spec.alpha * delta * delta)
    init = st.initialized
    new = Elastic(a_ema=torch.where(init, a_ema, total_area),
                  a_var=torch.where(init, a_var, 0.0),
                  debt_kbits=torch.where(init, debt, 0.0),
                  initialized=torch.ones_like(init))
    extra = torch.where(init, borrowed, 0.0) - torch.where(init, repaid, 0.0)
    return new, extra


HIDDEN = 32


def utility_mlp(seed: int, device) -> Dict[str, torch.Tensor]:
    """The utility MLP's initialisation from ``PRNGKey(seed)``: one split
    key per leaf in sorted-name order, fan-in scaled threefry normals."""
    defs = {"w1": ((4, HIDDEN), True), "b1": ((HIDDEN,), False),
            "w2": ((HIDDEN, HIDDEN), True), "b2": ((HIDDEN,), False),
            "w3": ((HIDDEN, 1), True), "b3": ((1,), False)}
    names = sorted(defs)
    keys = split(prng_key(seed, device), len(names))
    out = {}
    for i, n in enumerate(names):
        shape, is_normal = defs[n]
        if not is_normal:
            out[n] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        fan_in = int(np.prod(shape[:-1]))
        std = float(np.float32(2.0 / np.sqrt(max(fan_in, 1))))
        out[n] = (normal(keys[i], shape) * std).to(torch.float32)
    return out


def utility_table(mlp, a, c, bitrates, resolutions, weights):
    I, J, R = a.shape[0], bitrates.shape[0], resolutions.shape[0]
    aa = a[:, None, None].expand(I, J, R).reshape(-1)
    cc_ = c[:, None, None].expand(I, J, R).reshape(-1)
    bb = bitrates[None, :, None].expand(I, J, R).reshape(-1)
    rr = resolutions[None, None, :].expand(I, J, R).reshape(-1)
    x = torch.stack([aa, cc_, log(bb / 50.0) / 3.5, rr], dim=-1)
    h = torch.relu(x @ mlp["w1"] + mlp["b1"])
    h = torch.relu(h @ mlp["w2"] + mlp["b2"])
    util_r = torch.sigmoid(h @ mlp["w3"] + mlp["b3"])[..., 0].reshape(I, J, R)
    best_r_idx = torch.argmax(util_r, dim=-1)
    best = util_r.max(dim=-1).values * weights[:, None]
    return best, resolutions[best_r_idx]


DP_NEG = -1e30


def dp_grid(bitrates: Sequence[int]) -> int:
    d = 0
    for b in bitrates:
        d = math.gcd(d, int(b))
    return d


def dp_capacity(spec: FleetSpec) -> int:
    """The static DP capacity in grid units: the pinned ceiling plus the
    minimum bitrate of every camera, bucketed to a multiple of 128 less
    one."""
    d = dp_grid(spec.bitrates)
    w_max = float(spec.w_cap_kbps) + float(min(spec.bitrates)) \
        * spec.num_cameras
    wg = int(w_max // d)
    return ((wg + 1 + 127) // 128) * 128 - 1


def knapsack(util, costs, W: int):
    """The DP sweep: (values (W+1,), choices (I, W+1))."""
    I, J = util.shape
    dev = util.device
    src = (torch.arange(W + 1, device=dev)[:, None]
           - costs.to(torch.int64)[None])
    valid = src >= 0
    src = torch.clamp(src, min=0)
    v = torch.zeros((W + 1,), dtype=torch.float32, device=dev)
    choices = []
    for i in range(I):
        cand = torch.where(valid, v[src] + util[i][None, :], DP_NEG)
        j = torch.argmax(cand, dim=1)
        v = torch.gather(cand, 1, j[:, None])[:, 0]
        choices.append(j.to(torch.int32))
    return v, torch.stack(choices)


def backtrack(choices, costs, values, Wg):
    I = choices.shape[0]
    w_idx = torch.arange(values.shape[0], device=values.device)
    masked = torch.where(w_idx <= Wg, values, DP_NEG)
    total = masked.max()
    w = torch.argmax(masked).reshape(1)
    costs = costs.to(torch.int64)
    picks = []
    for i in range(I - 1, -1, -1):
        j = choices[i].gather(0, w).to(torch.int64)
        picks.append(j)
        w = torch.clamp(w - costs.gather(0, j), min=0)
    return torch.cat(picks[::-1]), total


def allocate_dp(util, best_res, bitrates: Sequence[int], W_kbps, w_cap: int,
                rates, live):
    """Knapsack allocation with dead cameras forced onto the cheapest
    option: (b (I,), res (I,), feasible)."""
    d = dp_grid(bitrates)
    costs_np = np.asarray(bitrates, np.int64) // d
    I, J = util.shape
    dev = util.device
    jmin = int(np.argmin(costs_np))
    cmin = int(costs_np[jmin])
    costs = (rates / d).to(torch.int32)
    W = W_kbps.to(torch.float32)
    open_ = W > 0.0
    n_live = live.to(torch.int32).sum()
    forced = torch.where(torch.arange(J, device=dev) == jmin, 0.0, -1e9)
    util_eff = torch.where(live[:, None], util, forced[None, :])
    Wg = torch.clamp(torch.floor(W / d).to(torch.int32), max=w_cap)
    feasible = (cmin * n_live <= Wg) & open_
    Wg_eff = torch.clamp(Wg + (I - n_live) * cmin, max=w_cap)
    vals, choices = knapsack(util_eff, costs, int(w_cap))
    picks, _ = backtrack(choices, costs, vals,
                         torch.clamp(Wg_eff, min=cmin * I))
    tx = live & open_
    b = torch.where(tx, rates[picks], 0.0)
    res = torch.where(tx, best_res[torch.arange(I, device=dev), picks], 1.0)
    return b, res, feasible


# -- encode ------------------------------------------------------------------

def pool_factor(res: float) -> int:
    if res >= 0.999:
        return 1
    return 2 if res > 0.6 else 4 if res > 0.3 else 8


def _avg_pool(frames, k: int):
    H, W = frames.shape[-2:]
    x = frames[..., :H // k * k, :W // k * k]
    x = x.reshape(*x.shape[:-2], H // k, k, W // k, k)
    s = None
    for i in range(k):
        for j in range(k):
            v = x[..., :, i, :, j]
            s = v if s is None else s + v
    return s / float(k * k)


def blur(frames, k: int):
    if k == 1:
        return frames
    H, W = frames.shape[-2:]
    up = _avg_pool(frames, k).repeat_interleave(k, dim=-2).repeat_interleave(
        k, dim=-1)
    ph, pw = H - up.shape[-2], W - up.shape[-1]
    if ph or pw:
        lead = up.shape[:-2]
        up = F.pad(up.reshape(-1, 1, *up.shape[-2:]), (0, pw, 0, ph),
                   mode="replicate").reshape(*lead, H, W)
    return up


def encode(spec: FleetSpec, frames, roi_pixels, b, res, keys, n_eff,
           res_table, pool_table):
    """frames (C, N, H, W) -> (decoded frames, size in bytes (C,))."""
    pix = roi_pixels * res * res * (1.0 + spec.temporal_rho * (n_eff - 1))
    bits = b * 1000.0 * spec.slot_seconds
    bpp = bits / torch.clamp(pix, min=1.0)
    levels = torch.clamp(spec.quant_scale * bpp, 4.0, 256.0)
    sigma = spec.sigma0 * torch.exp(-bpp / spec.beta)
    size = bits / 8.0
    nearest = torch.argmin(torch.abs(res_table[None, :] - res[:, None]),
                           dim=1)
    kcam = pool_table[nearest]
    noise = normal(keys, frames.shape[1:])
    out = torch.empty_like(frames)
    for c, k in enumerate(kcam.tolist()):
        x = blur(frames[c], k)
        x = torch.round(x * levels[c]) / levels[c]
        out[c] = torch.clamp(fma(noise[c], sigma[c], x), 0.0, 1.0)
    return out, size


def crop_to_mask(frames, masks, block_size: int):
    up = masks.repeat_interleave(block_size, dim=1).repeat_interleave(
        block_size, dim=2)[:, None]
    fill = frames.mean(dim=(2, 3), keepdim=True)
    return torch.where(up, frames, fill)


def _linspace_sel(count, F_: int):
    j = torch.arange(F_, device=count.device)[None, :]
    count = torch.clamp(count.to(torch.int64), min=1)[:, None]
    f_eff = torch.clamp(count, max=F_)
    jj = torch.minimum(j, f_eff - 1)
    pos = (jj * (count - 1)) // torch.clamp(f_eff - 1, min=1)
    return pos, f_eff[:, 0]


def _rows(x, idx):
    ci = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[ci, idx]


# -- the slot and the window ---------------------------------------------------

CODEC_KEY_SALT = 0x0DEC
LOG_KEYS = ("utility", "mean_f1", "bytes", "W", "extra", "area",
            "alloc_kbps")


class FleetReference:
    """The deepstream fleet of one configuration and seed, slot by slot."""

    def __init__(self, cfg: Dict, seed: int, device, weights_dir: Path,
                 detector_dtype: torch.dtype = torch.float32):
        self.spec = spec = FleetSpec.of(cfg)
        self.device = dev = torch.device(device)
        self.dtype = detector_dtype
        self.scene = init_scene(spec, seed, dev)
        self.scene_key = prng_key(seed, dev)
        self.run_key = prng_key(spec.run_key_seed, dev)
        self.light = load_detector(Path(weights_dir) / "detector_light", dev)
        self.server = load_detector(Path(weights_dir) / "detector_server",
                                    dev)
        self.mlp = utility_mlp(spec.mlp_seed, dev)
        f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32),
                                        device=dev)
        self.rates = f32(spec.bitrates)
        self.res_table = f32(spec.resolutions)
        self.pool_table = torch.as_tensor(
            [pool_factor(r) for r in spec.resolutions], dtype=torch.int32,
            device=dev)
        self.lam = f32(np.ones(spec.num_cameras))
        self.tau_wl, self.tau_wh = f32(spec.tau_wl), f32(spec.tau_wh)
        self.w_cap = dp_capacity(spec)

    def control(self, est: Elastic, area_total, W_t, live, reconnect):
        """The elastic step alone, for slots the comparison does not
        recompute: (new state, extra Kbps)."""
        est, extra_kbits = elastic_update(self.spec, est, area_total, W_t,
                                          self.tau_wl, self.tau_wh,
                                          reconnect)
        return est, extra_kbits / self.spec.slot_seconds

    def slot(self, t: int, W_kbps: float, live_np: np.ndarray, est: Elastic,
             live_prev: np.ndarray):
        """One slot -> (f1/sizes pack (2, C), control pack (4,), new
        state)."""
        spec, dev = self.spec, self.device
        C, N = spec.num_cameras, spec.frames
        W_t = torch.as_tensor(np.float32(W_kbps), device=dev)
        live = torch.as_tensor(np.asarray(live_np, bool), device=dev)
        prev = torch.as_tensor(np.asarray(live_prev, bool), device=dev)
        # the slot index as the program holds it: a 0-d int64 tensor
        t = torch.as_tensor(int(t), dtype=torch.int64, device=dev)
        frames, gtb, gtv = segment(spec, self.scene, self.scene_key, t)
        kt = fold_in(fold_in(self.run_key, CODEC_KEY_SALT), t)
        keys = fold_in(kt, self.scene.cam_ids.to(torch.int64))
        reconnect = (live & ~prev).any()
        masks, a, c = roidet(frames, self.light, spec.block_size, self.dtype)
        area = torch.where(live, a, 0.0).sum()
        est, extra = self.control(est, area, W_t, live, reconnect)
        util, best_res = utility_table(self.mlp, a, c, self.rates,
                                       self.res_table, self.lam)
        W_eff = torch.clamp(W_t + extra, min=0.0)
        b, r, feasible = allocate_dp(util, best_res, spec.bitrates, W_eff,
                                     self.w_cap, self.rates, live)
        cpack = torch.stack([extra, area, b.sum(),
                             feasible.to(torch.float32)])
        # encode: every frame kept (no reducto keep), F evenly spaced
        F_ = min(spec.eval_frames, N)
        keep = torch.ones((C, N), dtype=torch.bool, device=dev)
        kept_pos = torch.argsort(1 - keep.to(torch.uint8), dim=1,
                                 stable=True)
        m = keep.sum(dim=1)
        ev_p, f_eff = _linspace_sel(m, F_)
        eval_idx = torch.gather(kept_pos, 1, ev_p)
        j = torch.arange(F_, device=dev)[None, :]
        eval_w = torch.where(j < f_eff[:, None],
                             1.0 / torch.clamp(f_eff[:, None], min=1),
                             0.0).to(torch.float32)
        n_eff = m.to(torch.float32)
        cropped = crop_to_mask(frames, masks, spec.block_size)
        roi_pixels = (masks.sum(dim=(1, 2))
                      * spec.block_size ** 2).to(torch.float32)
        decoded, sizes = encode(spec, cropped, roi_pixels, b, r, keys, n_eff,
                                self.res_table, self.pool_table)
        H, W = spec.height, spec.width
        batch = _rows(decoded, eval_idx).reshape(C * F_, H, W)
        gt_e, gv_e = _rows(gtb, eval_idx), _rows(gtv, eval_idx)
        tx = live & (b > 0.0)
        # finish: server detector, box decode, greedy F1
        G = gt_e.shape[2]
        grid = detector_forward(self.server, batch, self.dtype)
        boxes, _, valid = decode_boxes(grid,
                                       conf_thresh=spec.conf_thresh_server)
        f1_frames = f1_score_batch(boxes, valid, gt_e.reshape(C * F_, G, 4),
                                   gv_e.reshape(C * F_, G)).reshape(C, F_)
        f1 = (f1_frames * eval_w).sum(dim=1)
        f1 = torch.where(tx, f1, 0.0)
        sizes = torch.where(tx, sizes, 0.0)
        return torch.stack([f1, sizes]), cpack, est

    def window_logs(self, W: np.ndarray, packs: List[torch.Tensor],
                    cpacks: List[torch.Tensor]) -> Dict[str, np.ndarray]:
        """A window's logs from its slots' packs, reduced on the host as the
        serving runner reduces them."""
        p = torch.stack(packs).cpu().numpy()
        cp = torch.stack(cpacks).cpu().numpy()
        lam = np.ones(self.spec.num_cameras, np.float64)
        return {"utility": p[:, 0] @ lam, "mean_f1": p[:, 0].mean(axis=1),
                "bytes": p[:, 1].sum(axis=1),
                "W": np.asarray(W, float),
                "extra": cp[:, 0].astype(float),
                "area": cp[:, 1].astype(float),
                "alloc_kbps": cp[:, 2].astype(float)}


def compare(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """Per log key, the widest gap between the program's and the
    reference's values over the compared slots, as a share of the largest
    reference magnitude of that key (floored at 1e-6)."""
    out = {}
    for k in LOG_KEYS:
        p = np.asarray(prog[k], np.float64)
        r = np.asarray(ref[k], np.float64)
        if p.shape != r.shape:
            out[k] = math.inf
            continue
        scale = max(float(np.max(np.abs(r))) if r.size else 0.0, 1e-6)
        gap = np.abs(p - r)
        out[k] = (math.inf if not np.all(np.isfinite(p))
                  else float(np.max(gap)) / scale if gap.size else 0.0)
    return out
