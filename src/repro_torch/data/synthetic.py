"""Synthetic multi-camera scenes and bandwidth traces.

``MultiCameraScene`` is the stateful numpy world of
``repro.data.synthetic`` (objects that spawn, move and leave, rendered per
camera with view offsets and time lags), copied so that it draws in the
same order: its frames and boxes are bitwise the JAX package's.  It stays
on the host; the system uploads each segment.

``DeviceScene`` is the counterpart of the JAX package's episode generator:
slot t's frames and padded ground truth are a pure function of (scene
params, base key, t).  Geometry (backgrounds with the parked objects baked
in, per-camera view offsets and time lags, the periodic object pool) is
drawn once with ``numpy.random.default_rng(cfg.seed)``, verbatim from the
JAX package; the per-slot sensor noise is ``normal(fold_in(fold_in(key,
t), cam_id))`` from the port's threefry, so frames are bitwise equal to
the JAX generator's.

XLA's CPU backend contracts ``a * b + c`` into a fused multiply-add and
folds the constant noise scale into ``normal``'s sqrt(2) factor; the paint
coordinates and the noise add below do the same (``prng.fma``,
``prng.normal_erfinv``) so the pixels match bit for bit.
"""
from __future__ import annotations

import dataclasses
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import resolve_device


@dataclass(frozen=True)
class SceneConfig:
    num_cameras: int = 5
    height: int = 96
    width: int = 160
    fps: int = 10
    seg_seconds: float = 1.0           # paper: T = 1s, 10 frames/segment
    max_objects: int = 8               # concurrent world objects cap
    spawn_rate: float = 0.35           # new objects per world-step (poisson)
    mean_speed: float = 3.0            # px / frame
    obj_size_range: Tuple[int, int] = (8, 26)
    num_stationary: int = 2            # parked objects per camera
    view_jitter: float = 6.0           # per-camera view offset scale (px)
    cam_lag_frames: int = 2            # max per-camera time lag
    noise_std: float = 0.02
    seed: int = 0

    @property
    def frames_per_segment(self) -> int:
        return int(self.fps * self.seg_seconds)


@dataclass
class WorldObject:
    x: float; y: float; vx: float; vy: float
    w: int; h: int; val: float; ttl: int


class MultiCameraScene:
    """Streaming host generator: each ``segment()`` advances the world one
    slot and renders every camera's frames and ground-truth boxes.  Every
    draw comes from ``numpy.random.default_rng(cfg.seed)`` in the JAX
    package's order."""

    def __init__(self, cfg: SceneConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        c = cfg
        # per-camera static background texture (smooth noise)
        self.backgrounds = []
        for _ in range(c.num_cameras):
            base = self.rng.uniform(0.25, 0.55, (c.height // 8, c.width // 8))
            bg = np.kron(base, np.ones((8, 8)))[:c.height, :c.width]
            self.backgrounds.append(bg.astype(np.float32))
        # per-camera view translation and time lag
        self.offsets = [(self.rng.uniform(-c.view_jitter, c.view_jitter),
                         self.rng.uniform(-c.view_jitter, c.view_jitter))
                        for _ in range(c.num_cameras)]
        self.lags = [int(self.rng.integers(0, c.cam_lag_frames + 1))
                     for _ in range(c.num_cameras)]
        # parked objects per camera: (x, y, w, h, value)
        self.stationary: List[List[Tuple[int, int, int, int, float]]] = []
        for _ in range(c.num_cameras):
            objs = []
            for _ in range(c.num_stationary):
                w = int(self.rng.integers(*c.obj_size_range))
                h = int(self.rng.integers(*c.obj_size_range))
                x = int(self.rng.integers(0, c.width - w))
                y = int(self.rng.integers(0, c.height - h))
                objs.append((x, y, w, h, float(self.rng.uniform(0.7, 0.95))))
            self.stationary.append(objs)
        self.objects: List[WorldObject] = []
        self._frame_idx = 0
        self._phase0 = float(self.rng.uniform(0, 2 * np.pi))
        self._history: List[List[WorldObject]] = []  # world state per frame

    def _step_world(self) -> None:
        """One frame of world time: move and age the objects, drop the
        expired and the far off-screen ones, spawn new ones at a rate that
        follows a slow traffic wave."""
        c = self.cfg
        for o in self.objects:
            o.x += o.vx + self.rng.normal(0, 0.3)
            o.y += o.vy + self.rng.normal(0, 0.3)
            o.ttl -= 1
        self.objects = [o for o in self.objects
                        if o.ttl > 0 and -40 < o.x < c.width + 40
                        and -40 < o.y < c.height + 40]
        phase = 2 * np.pi * self._frame_idx / 120.0
        activity = max(0.05, 1.0 + 1.2 * np.sin(phase + self._phase0))
        n_new = self.rng.poisson(c.spawn_rate * activity)
        for _ in range(n_new):
            if len(self.objects) >= c.max_objects:
                break
            side = self.rng.integers(0, 2)
            speed = max(0.5, self.rng.normal(c.mean_speed, 1.0))
            if side == 0:   # left -> right
                x, vx = -20.0, speed
            else:           # right -> left
                x, vx = float(c.width + 20), -speed
            y = float(self.rng.uniform(0.15, 0.85) * c.height)
            self.objects.append(WorldObject(
                x=x, y=y, vx=vx, vy=float(self.rng.normal(0, 0.2)),
                w=int(self.rng.integers(*c.obj_size_range)),
                h=int(self.rng.integers(*c.obj_size_range)),
                val=float(self.rng.uniform(0.6, 1.0)),
                ttl=int(self.rng.integers(60, 240))))
        self._history.append([dataclasses.replace(o) for o in self.objects])
        self._frame_idx += 1

    def _render(self, cam: int, world: List[WorldObject]
                ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
        """One camera's view of one world state: (frame (H, W) float32,
        xyxy boxes of the parked and the visible moving objects)."""
        c = self.cfg
        ox, oy = self.offsets[cam]
        frame = self.backgrounds[cam].copy()
        boxes: List[Tuple[int, int, int, int]] = []
        for (x, y, w, h, v) in self.stationary[cam]:
            frame[y:y + h, x:x + w] = v
            boxes.append((x, y, x + w, y + h))
        for o in world:
            x0 = int(round(o.x + ox))
            y0 = int(round(o.y + oy))
            x1, y1 = x0 + o.w, y0 + o.h
            cx0, cy0 = max(0, x0), max(0, y0)
            cx1, cy1 = min(c.width, x1), min(c.height, y1)
            if cx1 - cx0 < 3 or cy1 - cy0 < 3:
                continue
            frame[cy0:cy1, cx0:cx1] = o.val
            # a darker "windshield" stripe, so objects have inner edges
            frame[cy0 + (cy1 - cy0) // 3: cy0 + (cy1 - cy0) // 2,
                  cx0:cx1] = o.val * 0.6
            boxes.append((cx0, cy0, cx1, cy1))
        noisy = frame + self.rng.normal(0, c.noise_std, frame.shape)
        return np.clip(noisy, 0, 1).astype(np.float32), boxes

    def segment(self) -> Dict:
        """Advance one slot: {"frames": (C, N, H, W) float32 numpy,
        "boxes": per camera and frame the list of GT boxes, "t": the slot
        index}."""
        c = self.cfg
        n = c.frames_per_segment
        for _ in range(n):
            self._step_world()
        frames = np.zeros((c.num_cameras, n, c.height, c.width), np.float32)
        boxes: List[List[List[Tuple[int, int, int, int]]]] = []
        for cam in range(c.num_cameras):
            cam_boxes = []
            for f in range(n):
                idx = max(0, self._frame_idx - n + f - self.lags[cam])
                idx = min(idx, len(self._history) - 1)
                frame, bxs = self._render(cam, self._history[idx])
                frames[cam, f] = frame
                cam_boxes.append(bxs)
            boxes.append(cam_boxes)
        return {"frames": frames, "boxes": boxes,
                "t": self._frame_idx // n - 1}


class DeviceSceneParams(NamedTuple):
    """Per-scene buffers consumed by ``segments_device``."""
    backgrounds: torch.Tensor   # (C, H, W) f32, stationary objects baked in
    stat_boxes: torch.Tensor    # (C, S, 4) f32 xyxy GT of stationary objects
    stat_valid: torch.Tensor    # (C, S) bool
    offsets: torch.Tensor       # (C, 2) f32 per-camera view offset (ox, oy)
    lags: torch.Tensor          # (C,) int32 per-camera time lag (frames)
    cam_ids: torch.Tensor       # (C,) int32 global camera index
    objects: torch.Tensor       # (K, 10) f32 pool: [side, speed, y0, vy,
                                #   w, h, val, phase, period, ttl]


def init_device_scene(cfg: SceneConfig, device, mesh=None
                      ) -> DeviceSceneParams:
    """Draw the scene geometry once on the host (numpy, the JAX package's
    seed discipline) and place it on ``device``.  With a camera ``mesh``
    the whole fleet is drawn (the draws' order is the fleet's) and only
    this rank's rows of its padded form go up (``scene_rows``)."""
    if mesh is not None:
        host = init_device_scene(cfg, "cpu")
        return DeviceSceneParams(*(x.to(device) for x in scene_rows(
            host, mesh, cfg.num_cameras)))
    rng = np.random.default_rng(cfg.seed)
    C, H, W = cfg.num_cameras, cfg.height, cfg.width
    backgrounds = np.zeros((C, H, W), np.float32)
    for i in range(C):
        base = rng.uniform(0.25, 0.55, (H // 8, W // 8))
        backgrounds[i] = np.kron(base, np.ones((8, 8)))[:H, :W]
    offsets = rng.uniform(-cfg.view_jitter, cfg.view_jitter, (C, 2))
    lags = rng.integers(0, cfg.cam_lag_frames + 1, C)
    S = cfg.num_stationary
    stat_boxes = np.zeros((C, S, 4), np.float32)
    for i in range(C):
        for s in range(S):
            w = int(rng.integers(*cfg.obj_size_range))
            h = int(rng.integers(*cfg.obj_size_range))
            x = int(rng.integers(0, W - w))
            y = int(rng.integers(0, H - h))
            v = float(rng.uniform(0.7, 0.95))
            backgrounds[i, y:y + h, x:x + w] = v
            stat_boxes[i, s] = (x, y, x + w, y + h)
    K = cfg.max_objects
    period = rng.integers(140, 320, K).astype(np.float32)
    objects = np.stack([
        rng.integers(0, 2, K).astype(np.float32),              # side
        np.maximum(0.5, rng.normal(cfg.mean_speed, 1.0, K)),   # speed
        rng.uniform(0.15, 0.85, K) * H,                        # y0
        rng.normal(0, 0.2, K),                                 # vy
        rng.integers(*cfg.obj_size_range, K).astype(np.float32),
        rng.integers(*cfg.obj_size_range, K).astype(np.float32),
        rng.uniform(0.6, 1.0, K),                              # val
        rng.uniform(0, period),                                # phase
        period,
        np.minimum(rng.integers(60, 240, K), period - 30),     # ttl
    ], axis=1).astype(np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                     device=device)
    return DeviceSceneParams(
        backgrounds=t(backgrounds), stat_boxes=t(stat_boxes),
        stat_valid=torch.ones((C, S), dtype=torch.bool, device=device),
        offsets=t(offsets.astype(np.float32)),
        lags=t(lags, torch.int32),
        cam_ids=torch.arange(C, dtype=torch.int32, device=device),
        objects=t(objects))


def pad_scene_params(params: DeviceSceneParams, c_pad: int
                     ) -> DeviceSceneParams:
    """Pad the camera axis to ``c_pad`` with inert cameras (zero
    background, invalid stationary GT, fresh global cam ids); the object
    pool is shared world state and stays as it is."""
    from repro_torch.sharding.rules import pad_leading
    C = params.backgrounds.shape[0]
    if c_pad == C:
        return params
    return DeviceSceneParams(
        backgrounds=pad_leading(params.backgrounds, c_pad),
        stat_boxes=pad_leading(params.stat_boxes, c_pad),
        stat_valid=pad_leading(params.stat_valid, c_pad, False),
        offsets=pad_leading(params.offsets, c_pad),
        lags=pad_leading(params.lags, c_pad),
        cam_ids=torch.arange(c_pad, dtype=params.cam_ids.dtype,
                             device=params.cam_ids.device),
        objects=params.objects)


def scene_rows(params: DeviceSceneParams, mesh, num_cams: int
               ) -> DeviceSceneParams:
    """This rank's rows of an n-camera scene's whole-fleet params (padded
    to the mesh, then sliced; the object pool is shared); the params
    themselves when unsharded."""
    from repro_torch.sharding import rules
    if mesh is None:
        return params
    lo, hi = rules.camera_rows(num_cams, mesh)
    params = pad_scene_params(params, rules.pad_cameras(num_cams, mesh))
    return DeviceSceneParams(*(x[lo:hi] for x in params[:-1]),
                             params.objects)


def segments_device(cfg: SceneConfig, params: DeviceSceneParams,
                    key: torch.Tensor, t, *, gt_pad: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(params, base key, slot t) -> (frames (C, N, H, W), gt_boxes
    (C, N, G, 4), gt_valid (C, N, G)); G = ``gt_pad`` holds the stationary
    boxes then the object pool, invalid entries zeroed.  ``t`` is a Python
    int or a 0-d integer tensor on the params' device (the episode's slot
    index): either way nothing goes between host and device.  C comes
    from ``params``: a rank's rows of a camera mesh (``scene_rows``) make
    that rank's frames."""
    C = params.backgrounds.shape[0]
    N, H, W = cfg.frames_per_segment, cfg.height, cfg.width
    K, S = params.objects.shape[0], params.stat_boxes.shape[1]
    if gt_pad < S + K:
        raise ValueError(f"gt_pad {gt_pad} < {S + K} boxes per frame")
    dev = params.backgrounds.device

    # per-(camera, frame) world time, clamped at 0
    f = torch.arange(N, dtype=torch.int32, device=dev)
    g = torch.clamp(t * N + f[None, :] - params.lags[:, None], min=0)
    gf = g.to(torch.float32)[None]                                 # (1, C, N)

    o = params.objects
    side, speed, y0, vy, w_o, h_o, val, phase, period, ttl = (
        o[:, i, None, None] for i in range(10))                    # (K, 1, 1)
    u = torch.remainder(gf + phase, period)                        # (K, C, N)
    active = u < ttl
    x = torch.where(side > 0.5, prng.fma(-speed, u, W + 20.0),
                    prng.fma(speed, u, -20.0))
    y = prng.fma(vy, u, y0)
    ox = params.offsets[None, :, 0, None]
    oy = params.offsets[None, :, 1, None]
    x0 = torch.round(x + ox)
    y0_ = torch.round(y + oy)
    cx0 = torch.clamp(x0, 0, W)
    cy0 = torch.clamp(y0_, 0, H)
    cx1 = torch.clamp(x0 + w_o, 0, W)
    cy1 = torch.clamp(y0_ + h_o, 0, H)
    ok = active & (cx1 - cx0 >= 3) & (cy1 - cy0 >= 3)              # (K, C, N)

    frames = params.backgrounds[:, None].expand(C, N, H, W).reshape(
        C * N, H, W).clone()
    # paint each object through an object-sized window: the window origin
    # is clamped inside the frame and the masks compare absolute pixel
    # coordinates, so border-clipped objects paint exactly their visible
    # [cx0, cx1) x [cy0, cy1) region
    PW = -(-(int(cfg.obj_size_range[1]) + 1) // 8) * 8
    win = torch.arange(PW, dtype=torch.float32, device=dev)
    win_i = torch.arange(PW, dtype=torch.int64, device=dev)
    b_idx = torch.arange(C * N, device=dev)[:, None, None]
    for k in range(K):
        cx0k, cx1k = cx0[k].reshape(-1), cx1[k].reshape(-1)
        cy0k, cy1k = cy0[k].reshape(-1), cy1[k].reshape(-1)
        x0k = torch.clamp(cx0k, 0, W - PW)                         # (C*N,)
        y0k = torch.clamp(cy0k, 0, H - PW)
        ys0 = cy0k + torch.floor((cy1k - cy0k) / 3.0)
        ys1 = cy0k + torch.floor((cy1k - cy0k) / 2.0)
        rows = y0k.to(torch.int64)[:, None, None] + win_i[None, :, None]
        cols = x0k.to(torch.int64)[:, None, None] + win_i[None, None, :]
        patch = frames[b_idx, rows, cols]                      # (B, PW, PW)
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
    kt = prng.fold_in(key, t)
    e = prng.normal_erfinv(prng.fold_in(kt, params.cam_ids.to(torch.int64)),
                           (N, H, W))
    scale = float(np.float32(cfg.noise_std) * np.float32(prng.SQRT2))
    frames = torch.clamp(prng.fma(e, scale, frames), 0.0, 1.0)

    mov_boxes = torch.stack([cx0, cy0, cx1, cy1], dim=-1)          # (K,C,N,4)
    mov_boxes = mov_boxes.permute(1, 2, 0, 3)                      # (C,N,K,4)
    mov_valid = ok.permute(1, 2, 0)                                # (C,N,K)
    gt_boxes = torch.cat(
        [params.stat_boxes[:, None].expand(C, N, S, 4), mov_boxes], dim=2)
    gt_valid = torch.cat(
        [params.stat_valid[:, None].expand(C, N, S), mov_valid], dim=2)
    gt_boxes = torch.where(gt_valid[..., None], gt_boxes, 0.0)
    if gt_pad > S + K:
        pad = gt_pad - S - K
        gt_boxes = torch.cat([gt_boxes, gt_boxes.new_zeros(C, N, pad, 4)], 2)
        gt_valid = torch.cat([gt_valid, gt_valid.new_zeros(C, N, pad)], 2)
    return frames, gt_boxes.contiguous(), gt_valid.contiguous()


class LazySegment(dict):
    """Segment dict whose host views (``boxes``) are built on first access:
    the fleet runners read only the device entries, so they never pay the
    GT fetch and the Python list build the sequential runner needs."""

    def __init__(self, base: Dict, lazy: Dict[str, Callable[[], object]]):
        super().__init__(base)
        self._lazy = lazy

    def __getitem__(self, k):
        if not super().__contains__(k) and k in self._lazy:
            self[k] = self._lazy.pop(k)()
        return super().__getitem__(k)

    def __contains__(self, k):
        return super().__contains__(k) or k in self._lazy

    def get(self, k, default=None):
        return self[k] if k in self else default


class DeviceScene:
    """A scene's device params, base key and slot cursor (``_t``), the
    counterpart of ``repro.data.synthetic.DeviceScene``.  ``segment()``
    yields slot ``_t`` and advances the cursor; its frames are bitwise what
    ``fleet_episode`` synthesises for the same (seed, t).  With a camera
    ``mesh`` (``sharding.rules.camera_mesh``) the params hold this rank's
    rows of the padded fleet only, and a segment is those rows."""

    def __init__(self, cfg: SceneConfig, device=None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = init_device_scene(cfg, self.device, mesh)
        self.key = prng.PRNGKey(cfg.seed, device=self.device)
        K = self.params.objects.shape[0]
        S = self.params.stat_boxes.shape[1]
        self.G = max(-(-(S + K) // 8) * 8, 16)
        self._t = 0

    def segment(self) -> LazySegment:
        """{"frames": (C, N, H, W), "t": slot index, "gt_dev": (gt_boxes
        (C, N, G, 4), gt_valid (C, N, G)), "boxes": per camera and frame
        the list of GT boxes (built on first access)}."""
        t = self._t
        self._t += 1
        frames, gtb, gtv = segments_device(self.cfg, self.params, self.key,
                                           t, gt_pad=self.G)

        def boxes():
            gtb_h, gtv_h = gtb.cpu().numpy(), gtv.cpu().numpy()
            return [[[tuple(b) for b, v in zip(gtb_h[c, f], gtv_h[c, f])
                      if v] for f in range(frames.shape[1])]
                    for c in range(frames.shape[0])]

        return LazySegment({"frames": frames, "t": t, "gt_dev": (gtb, gtv)},
                           {"boxes": boxes})


# the paper's FCC regime parameters (mean, std) in Kbps (section 7.1) and
# the clip floor its traces respect
FCC_PARAMS = {"low": (521.0, 230.0), "medium": (1134.0, 499.0),
              "high": (2305.0, 1397.0)}
FLOOR_KBPS = 64.0


def ar1_trace(rng: np.random.Generator, mu, sd: float, num_slots: int,
              rho: float = 0.8) -> np.ndarray:
    """AR(1) around a (scalar or per-slot) mean; innovations are drawn
    first, then x[0] (the JAX package's draw order)."""
    mu = np.broadcast_to(np.asarray(mu, np.float64), (num_slots,))
    eps = rng.normal(0, sd * np.sqrt(1 - rho ** 2), num_slots)
    x = np.empty(num_slots)
    x[0] = mu[0] + rng.normal(0, sd)
    for t in range(1, num_slots):
        x[t] = mu[t] + rho * (x[t - 1] - mu[t]) + eps[t]
    return x


def bandwidth_trace(kind: str, num_slots: int, seed: int = 0) -> np.ndarray:
    """FCC-like AR(1) trace with the paper's means/stds, clipped at the
    64 Kbps floor; the kind folds into the seed through ``zlib.crc32``."""
    mu, sd = FCC_PARAMS[kind]
    rng = np.random.default_rng(seed + zlib.crc32(kind.encode()) % 1000)
    return np.clip(ar1_trace(rng, mu, sd, num_slots), FLOOR_KBPS, None)
