"""DeepStream system entry point: the slot loops and the whole-trace episode.

The counterpart of ``repro.core.scheduler.DeepStreamSystem``.  A bandwidth
trace runs in one of three ways (``SystemConfig``):

  * ``run()`` with ``batched=True`` (default): the fleet slot loop.  Per
    slot the scene segment (a ``DeviceScene``'s, already on the device, or
    a host ``MultiCameraScene``'s, whose frames go up once through pinned
    memory and whose box lists are padded and uploaded once) feeds
    ROIDet, the control step, reducto's keep decision and
    ``fleet.fleet_slot_step`` (encode -> detect -> score over the camera
    axis, one code path for every method).  With
    ``alloc="device"`` (default) the control step
    (``fleet.fleet_control_step``: elastic, utility table, knapsack DP)
    stays on the device and the host fetches only the slot's (2, C) log
    pack and (4,) control pack; with ``pipeline=True`` (default) slot t's
    harvest waits until slot t+1 is dispatched.  ``alloc="host"`` runs the
    numpy control path (host elastic in float64, host DP solve) on one
    packed (a, c) fetch per slot.
  * ``run()`` with ``batched=False``: the sequential per-camera reference
    loop (host control; on the card each camera's encode goes through the
    tx_codec kernel with C = 1).
  * ``run_episode()`` (or ``run()`` with ``episode=True``): the whole trace
    in ``fleet.fleet_episode`` (pipelined and bucketed by default, the slot
    step replayed as a CUDA graph on the card), its logs fetched once.
    Nothing before that one harvest waits on the card: the run's inputs go
    up through pinned memory, and no slot reads the device.  An
    ``EpisodeCarry`` resumes a run where the last one stopped.

Every runner draws the same per-(slot, camera) coding keys
(``fleet.slot_camera_keys``), so their logs agree.  Every device-to-host
fetch of a loop goes through ``_d2h``, counted per category
(``d2h_fetch_counts``).  ``faults`` ((T, C) bool liveness) rides through
the batched and episode runners as in the JAX package.

``profile()`` is the offline step (paper sections 5.1 and 5.3.1b): on a
host ``MultiCameraScene`` it sweeps every (camera, bitrate, resolution)
masked and full, fits the utility MLP to the masked F1
(``utility.fit``), derives the elastic thresholds
(``elastic.offline_thresholds``) and averages jcab's content-agnostic
table.  The MLP lands on the system's device; the thresholds are floats
and the jcab table a (J, R) numpy array, read by ``run()`` as before.
Without it, callers set ``mlp``, ``tau_wl``/``tau_wh`` and ``jcab_table``
themselves.

Kernels are chosen by tensor device (the kernel for CUDA tensors, the plain
version for CPU tensors), so the JAX package's ``use_kernels`` has no
counterpart; nor do ``shard`` and ``donate`` (a camera mesh and buffer
donation have no meaning on one card).

``SystemConfig.checked`` is the diagnostics lane: the JAX package's
checkify invariants, computed on the device as a row of violation flags
per slot (``fleet.CONTROL_CHECKS`` / ``SLOT_CHECKS`` / ``EPISODE_CHECKS``)
that rides the log packs, inside the episode's CUDA graphs too.  The host
reads them with the harvest it makes anyway and raises the first violated
check in program order, with the JAX package's message
(``fleet.CheckError``); nothing waits on the card before the harvest.  As
in the JAX package, a checked episode runs the reference body; the
kernels stay on (the flags are plain tensor ops).

``EpisodeSupervisor`` wraps a system's runs in bounded retries, a
straggler watchdog (``ft.watchdog``) and a degraded-mode ladder
(``episode`` -> ``episode_chunked`` -> ``pipelined``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import resolve_device, upload
from repro_torch.core import allocation as alloc
from repro_torch.core import codec as codec_mod
from repro_torch.core import elastic as elastic_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core import roidet as roidet_mod
from repro_torch.core.codec import CodecConfig
from repro_torch.core.elastic import (ElasticConfig, ElasticState,
                                      HostElasticState)
from repro_torch.core import utility as util_mod
from repro_torch.data.synthetic import (DeviceScene, MultiCameraScene,
                                        SceneConfig)
from repro_torch.ft import watchdog as ft_watchdog
from repro_torch.kernels.edge_motion import ops as em_ops
from repro_torch.models import detector as det

METHODS = ("deepstream", "deepstream_no_elastic", "jcab", "reducto",
           "static")
MOTION_KEEP_THRESH = fleet_mod.MOTION_KEEP_THRESH
LOG_KEYS = ("utility", "mean_f1", "bytes", "W", "extra", "alloc_kbps",
            "area")

# -- device-to-host accounting ------------------------------------------------
# Categories: 'harvest' (log packs), 'keep' (the sequential reducto
# keep-flag fetch), 'control' (the host control path's (a, c) fetch).

D2H_CATEGORIES = ("harvest", "keep", "control")
_D2H_FETCHES: Dict[str, int] = {}


def d2h_fetch_counts() -> Dict[str, int]:
    """Per-category fetch counts since the process started."""
    return {k: _D2H_FETCHES.get(k, 0) for k in D2H_CATEGORIES}


def _d2h(x: torch.Tensor, kind: str) -> np.ndarray:
    _D2H_FETCHES[kind] = _D2H_FETCHES.get(kind, 0) + 1
    return x.cpu().numpy()


def _motion_keep(score_sums: np.ndarray, first: bool) -> np.ndarray:
    """(..., N) per-pair motion sums (pair 0 = frame 0 against the
    cross-slot reference) -> keep flags; frame 0 is forced kept on the
    run's first slot and on all-quiet slots."""
    keep = score_sums > MOTION_KEEP_THRESH
    keep[..., 0] |= first | ~keep.any(axis=-1)
    return keep


@dataclass
class SystemConfig:
    scene: SceneConfig = field(default_factory=SceneConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    block_size: int = 8
    weights: Optional[np.ndarray] = None      # lambda_i (default: ones)
    eval_frames: int = 4                      # frames scored per segment
    batched: bool = True                      # fleet slot loop vs per camera
    pipeline: bool = True                     # deferred-harvest slot loop
    alloc: str = "device"                     # control loop: "device" | "host"
    episode: bool = False                     # run() goes to run_episode()
    # the episode's pipelined body (slot t's finish beside slot t+1's
    # front, live cameras compacted); False runs the reference body it
    # equals bitwise
    episode_pipelined: bool = True
    # trace-length buckets of the episode (``fleet.bucket_len``): one CUDA
    # graph per (method, bucket) serves every T; None disables them
    episode_buckets: Optional[Tuple[int, ...]] = fleet_mod.EPISODE_BUCKETS
    # optional bandwidth ceiling (Kbps) pinning the DP capacity across runs
    w_cap_kbps: Optional[float] = None
    # the diagnostics lane: the JAX package's checkify invariants as device
    # flags read with the harvest; off by default, and an unchecked run
    # computes no flags (``checked`` is part of the episode graph's key)
    checked: bool = False

    def __post_init__(self):
        if self.alloc not in ("device", "host"):
            raise ValueError(f"alloc must be 'device' or 'host': "
                             f"{self.alloc!r}")
        if self.episode:
            if not self.batched:
                raise ValueError("episode mode requires batched=True")
            if self.alloc != "device":
                raise ValueError("episode mode requires alloc='device' "
                                 f"(got {self.alloc!r})")
        # the sequential loop has only the host control path
        if not self.batched:
            self.alloc = "host"

    def lam(self) -> np.ndarray:
        if self.weights is None:
            return np.ones(self.scene.num_cameras, np.float64)
        return np.asarray(self.weights, np.float64)


class EpisodeCarry(NamedTuple):
    """What one run hands to the next so that a chain of runs is slot for
    slot one run over the concatenated trace (the JAX package's serving
    carry).  ``est`` and ``ref`` stay on the device (they are not fetched);
    ``live_prev`` and ``t_first`` are host values.  The codec keys (a pure
    fold of the run key) and the scene (pure in seed and cursor) need no
    carry.  ``t_first`` is the stream's first global slot: reducto
    force-keeps frame 0 only there, so later windows keep the reference
    the carry hands them."""
    est: ElasticState            # device elastic EMA / variance / debt
    ref: torch.Tensor            # (C, H, W) reducto reference frames
    live_prev: np.ndarray        # (C,) bool last served liveness row
    t_first: int                 # stream-origin slot index


class DeepStreamSystem:
    def __init__(self, cfg: SystemConfig, light_params: Dict[str, Any],
                 server_params: Dict[str, Any], mlp_params=None, *,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        to_dev = lambda p: (None if p is None else
                            {k: torch.as_tensor(v).to(self.device)
                             for k, v in p.items()})
        self.light = to_dev(light_params)
        self.server = to_dev(server_params)
        self.mlp = to_dev(mlp_params)
        self.tau_wl: float = 0.0
        self.tau_wh: float = float("inf")
        self.jcab_table: Optional[np.ndarray] = None   # (J, R) agnostic F1
        self._key = prng.PRNGKey(1234, device=self.device)
        # the codec's bitrate, resolution and pool-factor tables on the
        # device: built once, read by every run's slot steps
        self._tables = codec_mod.device_tables(cfg.codec.bitrates_kbps,
                                               cfg.codec.resolutions,
                                               self.device)
        self._reducto_ref: Optional[torch.Tensor] = None   # batched runs
        self._reducto_ref_host: List[Optional[torch.Tensor]] = []
        self._G = fleet_mod.gt_capacity(
            cfg.scene.max_objects + cfg.scene.num_stationary)
        # the carry of the last run_episode or device-control run()
        self.last_carry: Optional[EpisodeCarry] = None

    # -- keys and segments ----------------------------------------------------

    def _nextkey(self) -> torch.Tensor:
        """The next key of the system's split chain (profiling draws)."""
        self._key, k = prng.split(self._key)
        return k

    def _keys(self, n: int) -> torch.Tensor:
        """n keys of the split chain, stacked (n, 2), in the order n
        ``_nextkey()`` calls would draw them."""
        self._key, subs = fleet_mod._key_chain(self._key, n)
        return subs

    def _frames_of(self, seg: Dict) -> torch.Tensor:
        """A segment's (C, N, H, W) frames on the system's device: a
        ``DeviceScene``'s as they are, a host scene's uploaded once through
        pinned memory."""
        fr = seg["frames"]
        return fr if torch.is_tensor(fr) else upload(fr, self.device,
                                                     np.float32)

    # -- camera side ----------------------------------------------------------

    def camera_features(self, frames: torch.Tensor) -> roidet_mod.ROIResult:
        """frames (C, N, H, W) -> the fleet ROIDet result (no sync)."""
        return roidet_mod.roidet_fleet(frames, self.light,
                                       block_size=self.cfg.block_size)

    # -- sequential path: one camera at a time --------------------------------

    def _encode_one(self, frames: torch.Tensor, roi_pixels: float, b: float,
                    r: float, key: torch.Tensor,
                    num_frames: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One camera's encode: the plain ``encode_segment`` for CPU
        tensors, the fleet encode with C = 1 (the tx_codec kernel) on the
        card.  Returns (decoded (N, H, W), size_bytes)."""
        cfg = self.cfg.codec
        if frames.device.type == "cpu":
            return codec_mod.encode_segment(cfg, frames, roi_pixels, b, r,
                                            key, num_frames=num_frames)
        f32 = lambda v: torch.tensor([v], dtype=torch.float32,
                                     device=frames.device)
        decoded, size = codec_mod.encode_fleet_segment(
            cfg, frames[None], f32(roi_pixels), f32(b), f32(r), key[None],
            None if num_frames is None else f32(num_frames),
            tables=self._tables)
        return decoded[0], size[0]

    def _detect(self, frames: torch.Tensor, idx) -> Tuple[np.ndarray,
                                                          np.ndarray]:
        """Server detections of ``frames[idx]``, fetched: (boxes, valid)."""
        sel = torch.as_tensor(np.asarray(idx), device=frames.device)
        grid = det.forward(self.server, frames[sel])
        boxes, _, valid = det.decode_boxes(grid, conf_thresh=0.4)
        return boxes.cpu().numpy(), valid.cpu().numpy()

    def detect_f1(self, decoded: torch.Tensor,
                  gt_frames: List[List[Tuple]]) -> float:
        """decoded (N, H, W); GT lists per frame -> mean F1 over
        ``eval_frames`` evenly spaced frames."""
        idxs = fleet_mod.eval_indices(decoded.shape[0], self.cfg.eval_frames)
        boxes, valid = self._detect(decoded, idxs)
        return float(np.mean([det.f1_score(boxes[i], valid[i], gt_frames[j])
                              for i, j in enumerate(idxs)]))

    def encode_eval(self, frames: torch.Tensor, gt: List[List[Tuple]],
                    mask: Optional[torch.Tensor], b: float, r: float,
                    key: Optional[torch.Tensor] = None) -> Tuple[float, float]:
        """Encode one camera's segment (ROI-masked when ``mask`` is given)
        under ``key`` (the runners' fold-in keys; None draws the next key
        of the split chain, as profiling does) and score it.  Returns
        (f1, size_bytes)."""
        H, W = frames.shape[-2:]
        bs = self.cfg.block_size
        if mask is not None:
            frames = roidet_mod.crop_to_mask(frames[None], mask[None], bs)[0]
            roi_pixels = float(mask.sum()) * bs ** 2
        else:
            roi_pixels = float(H * W)
        decoded, size = self._encode_one(
            frames, roi_pixels, b, r, self._nextkey() if key is None else key)
        return self.detect_f1(decoded, gt), float(size)

    def _encode_eval_all(self, frames: torch.Tensor,
                         gts: List[List[List[Tuple]]],
                         masks: Optional[torch.Tensor], b: np.ndarray,
                         r: np.ndarray, keys: torch.Tensor
                         ) -> Tuple[List[float], List[float]]:
        """Every camera's encode -> detect -> score, one at a time."""
        f1s, sizes = [], []
        for i in range(frames.shape[0]):
            f1, size = self.encode_eval(
                frames[i], gts[i], None if masks is None else masks[i],
                float(b[i]), float(r[i]), keys[i])
            f1s.append(f1)
            sizes.append(size)
        return f1s, sizes

    def _kept_eval_selection(self, keep_i: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """One camera's keep flags (N,) -> (kept frame indices, the ones of
        them scored for F1)."""
        kept_idx = np.flatnonzero(keep_i)
        sel = fleet_mod.eval_indices(len(kept_idx), self.cfg.eval_frames)
        return kept_idx, kept_idx[sel]

    def _reuse_f1(self, dets: Tuple[np.ndarray, np.ndarray],
                  gts_missed: List[List[Tuple]]) -> float:
        """Score filtered-out frames against the reused last detections."""
        boxes, valid = dets
        sel = fleet_mod.eval_indices(len(gts_missed), self.cfg.eval_frames)
        return float(np.mean([det.f1_score(boxes, valid, gts_missed[j])
                              for j in sel]))

    def _reducto_slot(self, frames: torch.Tensor,
                      gts: List[List[List[Tuple]]], bs: np.ndarray,
                      first: bool, keys: torch.Tensor
                      ) -> Tuple[List[float], List[float]]:
        """Sequential reducto slot, one camera at a time: edge-motion keep
        flags against the cross-slot reference (the last kept frame of the
        previous slot), the fixed-shape segment encoded with the kept-frame
        count, kept frames scored, filtered frames scored against the
        detections of the last kept raw frame."""
        f1s, sizes = [], []
        H, W = frames.shape[-2:]
        for i in range(frames.shape[0]):
            fr = frames[i]
            ref = fr[0] if first else self._reducto_ref_host[i]
            sc = em_ops.segment_motion(
                torch.cat([ref[None], fr]), block_size=self.cfg.block_size,
                edge_thresh=roidet_mod.EDGE_THRESH)             # (N, M, Nb)
            keep = _motion_keep(_d2h(sc.sum(dim=(1, 2)), "keep"), first)
            kept_idx, ev_idx = self._kept_eval_selection(keep)
            self._reducto_ref_host[i] = fr[int(kept_idx[-1])]
            decoded, size = self._encode_one(fr, float(H * W), float(bs[i]),
                                             1.0, keys[i],
                                             num_frames=float(len(kept_idx)))
            db, dv = self._detect(decoded, ev_idx)
            f1 = float(np.mean([det.f1_score(db[k], dv[k], gts[i][j])
                                for k, j in enumerate(ev_idx)]))
            if not keep.all():
                rb, rv = self._detect(fr, kept_idx[-1:])
                miss_idx = np.flatnonzero(~keep)
                f1_re = self._reuse_f1((rb[0], rv[0]),
                                       [gts[i][j] for j in miss_idx])
                w_keep = keep.mean()
                f1 = f1 * w_keep + f1_re * (1 - w_keep)
            f1s.append(f1)
            sizes.append(float(size))
        return f1s, sizes

    # -- fleet path -----------------------------------------------------------

    def _slot_dispatch(self, frames: torch.Tensor, gts,
                       masks: Optional[torch.Tensor], b, r, *,
                       keys: torch.Tensor, live: torch.Tensor,
                       tables: codec_mod.CodecTables,
                       keep: Optional[torch.Tensor] = None,
                       gt_dev: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                       checked: bool = False
                       ) -> fleet_mod.FleetSlotOut:
        """Dispatch the fleet slot step without waiting for it.  GT: the
        padded device arrays ``gt_dev`` when the segment has them (a
        ``DeviceScene``'s), else the host lists ``gts[cam][frame]``,
        padded to G (``fleet.pad_gt_all``) and uploaded.  masks None = no
        cropping; b, r (C,) tensors or arrays; keep None = every frame kept
        and no reuse arm (every method but reducto); ``tables`` the run's
        codec tables on the device; ``checked`` adds the slot checks'
        flags."""
        C, N, H, W = frames.shape
        dev = frames.device
        if gt_dev is None:
            gtb, gtv = fleet_mod.pad_gt_all(gts, N, G=self._G)
            gt_dev = (upload(gtb, dev), upload(gtv, dev))
        if masks is None:
            masks = roidet_mod.full_frame_mask(C, H, W, self.cfg.block_size,
                                               dev)
        with_reuse = keep is not None
        if keep is None:
            keep = torch.ones((C, N), dtype=torch.bool, device=dev)
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
        return fleet_mod.fleet_slot_step(
            self.cfg.codec, self.server, frames, masks, f32(b), f32(r), keys,
            keep, gt_dev[0], gt_dev[1], live,
            eval_frames=self.cfg.eval_frames,
            block_size=self.cfg.block_size, with_reuse=with_reuse,
            tables=tables, checked=checked)

    def fleet_encode_eval(self, frames: torch.Tensor, gts,
                          masks: Optional[torch.Tensor], b, r, *,
                          keys: Optional[torch.Tensor] = None,
                          gt_dev: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     fleet_mod.FleetSlotOut]:
        """Whole-fleet encode -> detect -> score in one slot step, no
        reuse arm, waited for (profiling and tests).  ``keys`` None draws
        the next C keys of the split chain.  Returns (per-frame F1s (C, F),
        sizes (C,), the raw ``FleetSlotOut``), fetched in one transfer."""
        C = frames.shape[0]
        if keys is None:
            keys = self._keys(C)
        live = torch.ones((C,), dtype=torch.bool, device=frames.device)
        out = self._slot_dispatch(frames, gts, masks, b, r, keys=keys,
                                  live=live, tables=self._tables,
                                  gt_dev=gt_dev)
        pack = torch.cat([out.f1_frames, out.sizes[:, None]], 1).cpu().numpy()
        return pack[:, :-1], pack[:, -1], out

    # -- offline profiling (paper sections 5.1 and 5.3.1b) --------------------

    def profile(self, scene: MultiCameraScene, num_slots: int = 10,
                mlp_steps: int = 600, seed: int = 0) -> Dict:
        """Profile ``num_slots`` segments of a host scene: per camera,
        bitrate and resolution the F1 of the ROI-masked encode (the MLP's
        targets, their (a, c, b, r) its features) and of the full frame
        (jcab's table); fit the MLP from ``init_utility_mlp(PRNGKey(seed))``
        for ``mlp_steps`` steps; derive (tau_wl, tau_wh) from the best
        masked F1 per bitrate.  ``batched`` sweeps a slot in J fleet calls
        of C*R*2 entries, else one ``encode_eval`` at a time; both draw
        the same keys.  Per slot the (a, c) features are fetched once and
        each fleet call's F1 table once.  Returns {"mlp_mse", "tau_wl",
        "tau_wh", "num_samples"}."""
        if not isinstance(scene, MultiCameraScene):
            raise TypeError(f"profile needs a MultiCameraScene, got "
                            f"{type(scene)!r}")
        cfgc = self.cfg.codec
        feats, tgts = [], []
        C = self.cfg.scene.num_cameras
        J = len(cfgc.bitrates_kbps)
        R = len(cfgc.resolutions)
        acc_table = np.zeros((num_slots, C, J), np.float32)
        jcab_acc = np.zeros((num_slots, C, J, R), np.float32)
        for t in range(num_slots):
            seg = scene.segment()
            frames = self._frames_of(seg)
            roi = self.camera_features(frames)
            a, c = torch.stack([roi.area_ratio, roi.confidence]).cpu().numpy()
            if self.cfg.batched:
                masked_f1, full_f1 = self._profile_slot_batched(seg, frames,
                                                                roi)
                for i in range(C):
                    for j, b in enumerate(cfgc.bitrates_kbps):
                        for k, r in enumerate(cfgc.resolutions):
                            feats.append((float(a[i]), float(c[i]),
                                          float(b), float(r)))
                            tgts.append(float(masked_f1[i, j, k]))
                acc_table[t] = masked_f1.max(-1)
                jcab_acc[t] = full_f1
            else:
                for i in range(C):
                    for j, b in enumerate(cfgc.bitrates_kbps):
                        best = 0.0
                        for k, r in enumerate(cfgc.resolutions):
                            f1, _ = self.encode_eval(
                                frames[i], seg["boxes"][i], roi.mask[i], b, r)
                            feats.append((float(a[i]), float(c[i]),
                                          float(b), float(r)))
                            tgts.append(f1)
                            best = max(best, f1)
                            f1_full, _ = self.encode_eval(
                                frames[i], seg["boxes"][i], None, b, r)
                            jcab_acc[t, i, j, k] = f1_full
                        acc_table[t, i, j] = best
        mlp = util_mod.init_utility_mlp(prng.PRNGKey(seed,
                                                     device=self.device))
        self.mlp, mse = util_mod.fit(mlp, np.array(feats), np.array(tgts),
                                     steps=mlp_steps)
        self.tau_wl, self.tau_wh = elastic_mod.offline_thresholds(
            self.cfg.elastic, acc_table, np.asarray(cfgc.bitrates_kbps))
        self.jcab_table = jcab_acc.mean(axis=(0, 1))          # (J, R)
        return {"mlp_mse": mse, "tau_wl": self.tau_wl,
                "tau_wh": self.tau_wh, "num_samples": len(tgts)}

    def _profile_slot_batched(self, seg: Dict, frames: torch.Tensor,
                              roi: roidet_mod.ROIResult
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """One slot of the sweep in J fleet calls (one per bitrate) of
        B = C*R*2 entries laid out (camera, resolution, masked/full).  The
        slot's GT is padded and uploaded once and repeated on the device.
        Keys: C*J*R*2 of the split chain, reshaped (C, J, R, 2), the order
        of the sequential branch's nesting.  Returns (masked_f1, full_f1),
        each (C, J, R)."""
        cfgc = self.cfg.codec
        C, N = frames.shape[:2]
        J = len(cfgc.bitrates_kbps)
        R = len(cfgc.resolutions)
        dev = frames.device
        keyseq = self._keys(C * J * R * 2).reshape(C, J, R, 2, 2)
        B = C * R * 2
        masks_cr = torch.stack([roi.mask, torch.ones_like(roi.mask)], dim=1)
        masks_b = masks_cr[:, None].expand(
            C, R, *masks_cr.shape[1:]).reshape(B, *masks_cr.shape[2:])
        frames_b = frames.repeat_interleave(R * 2, dim=0)
        r_b = self._tables.resolutions.repeat(C).repeat_interleave(2)
        gtb, gtv = fleet_mod.pad_gt_all(seg["boxes"], N, G=self._G)
        gt_b = (upload(gtb, dev).repeat_interleave(R * 2, dim=0),
                upload(gtv, dev).repeat_interleave(R * 2, dim=0))
        masked_f1 = np.zeros((C, J, R), np.float32)
        full_f1 = np.zeros((C, J, R), np.float32)
        for j, b in enumerate(cfgc.bitrates_kbps):
            f1f, _, _ = self.fleet_encode_eval(
                frames_b, None, masks_b,
                torch.full((B,), float(b), dtype=torch.float32, device=dev),
                r_b, keys=keyseq[:, j].reshape(B, 2), gt_dev=gt_b)
            f1 = f1f.mean(axis=1).reshape(C, R, 2)
            masked_f1[:, j] = f1[:, :, 0]
            full_f1[:, j] = f1[:, :, 1]
        return masked_f1, full_f1

    def _reducto_keep(self, frames: torch.Tensor, first: torch.Tensor
                      ) -> torch.Tensor:
        """Reducto keep flags on the device, the cross-slot reference
        threaded through ``self._reducto_ref``; ``first`` (C,) bool marks
        cameras that seed the reference from frame 0 (run start,
        reconnect)."""
        C, _, H, W = frames.shape
        if self._reducto_ref is None:
            self._reducto_ref = torch.zeros((C, H, W), dtype=torch.float32,
                                            device=frames.device)
        keep, self._reducto_ref = fleet_mod.reducto_keep_step(
            frames, self._reducto_ref, first,
            block_size=self.cfg.block_size,
            edge_thresh=roidet_mod.EDGE_THRESH)
        return keep

    # -- control ----------------------------------------------------------------

    def _jcab_utility_table(self):
        """jcab's content-agnostic (util (C, J), best_res (C, J)): the
        (J, R) table folded and lambda-weighted for every camera."""
        jt = self.jcab_table
        C = self.cfg.scene.num_cameras
        lam = self.cfg.lam()
        util = (np.repeat(jt.max(-1)[None], C, 0)
                * lam[:, None]).astype(np.float32)
        best_res = np.repeat(np.asarray(
            self.cfg.codec.resolutions, np.float32)[jt.argmax(-1)][None], C, 0)
        return util, best_res

    def _control_context(self, method: str, trace_kbps: np.ndarray,
                         use_elastic: bool) -> Dict[str, Any]:
        """Per-run uploads (none of them waits on the card): the trace,
        lambda, thresholds, the jcab table, a fresh elastic state and the
        static DP capacity."""
        cfgc = self.cfg.codec
        dev = self.device
        bitrates = tuple(int(b) for b in cfgc.bitrates_kbps)
        borrow = (self.cfg.elastic.budget_kbits / cfgc.slot_seconds
                  if use_elastic else 0.0)
        w_cap = alloc.trace_capacity(
            bitrates, trace_kbps, self.cfg.scene.num_cameras,
            elastic_borrow_kbps=borrow, pin_kbps=self.cfg.w_cap_kbps)
        f32 = lambda v: upload(v, dev, np.float32)
        ctx: Dict[str, Any] = dict(
            trace=f32(trace_kbps), lam=f32(self.cfg.lam()),
            tau_wl=f32(self.tau_wl), tau_wh=f32(self.tau_wh), w_cap=w_cap,
            est=elastic_mod.init_state(dev), jcab_util=None, jcab_res=None)
        if method == "jcab":
            util, best_res = self._jcab_utility_table()
            ctx["jcab_util"], ctx["jcab_res"] = f32(util), f32(best_res)
        return ctx

    def _slot_control_device(self, method: str, frames: torch.Tensor, t: int,
                             ctx: Dict[str, Any], use_elastic: bool,
                             live: torch.Tensor, reconnect: torch.Tensor,
                             tables: codec_mod.CodecTables):
        """One slot's control on the device: ROIDet's (a, c) tensors feed
        the elastic -> utility -> allocation step directly; ``live`` (C,)
        and ``reconnect`` (0-d) are device tensors, ``tables`` the run's
        codec tables.  Returns (b, r, masks, control pack), all tensors;
        the elastic state threads through ``ctx``."""
        a = c = masks = None
        if method in ("deepstream", "deepstream_no_elastic"):
            roi = self.camera_features(frames)
            masks, a, c = roi.mask, roi.area_ratio, roi.confidence
        cfgc = self.cfg.codec
        co = fleet_mod.fleet_control_step(
            self.mlp if a is not None else None, ctx["jcab_util"],
            ctx["jcab_res"], ctx["lam"], a, c, ctx["trace"][t], ctx["est"],
            ctx["tau_wl"], ctx["tau_wh"], live, reconnect, method=method,
            ecfg=self.cfg.elastic, bitrates=tuple(cfgc.bitrates_kbps),
            resolutions=tuple(cfgc.resolutions),
            slot_seconds=cfgc.slot_seconds, use_elastic=use_elastic,
            w_cap=ctx["w_cap"], num_cams=self.cfg.scene.num_cameras,
            tables=tables, checked=self.cfg.checked)
        ctx["est"] = co.est
        pack = co.pack
        if self.cfg.checked:
            pack = torch.cat([pack, co.flags])
        return co.b, co.r, masks, pack

    def _slot_allocation(self, method: str, frames: torch.Tensor, W_t: float,
                         est: HostElasticState, use_elastic: bool,
                         live: Optional[np.ndarray] = None,
                         reconnect: bool = False):
        """One slot's control on the host: features (deepstream only, one
        packed (a, c) fetch) -> float64 elastic -> host allocation.  Dead
        cameras leave the area signal and every allocator; ``reconnect``
        clears the elastic debt first.  Returns (b, r, masks, extra, area,
        alloc_kbps, est)."""
        cfgc = self.cfg.codec
        lam = self.cfg.lam()
        C = self.cfg.scene.num_cameras
        bitrates = list(cfgc.bitrates_kbps)
        live = np.ones(C, bool) if live is None else live
        masks = None
        extra = area = 0.0
        if method in ("deepstream", "deepstream_no_elastic"):
            roi = self.camera_features(frames)
            ac = _d2h(torch.stack([roi.area_ratio, roi.confidence]),
                      "control")
            a, c = ac[0], ac[1]
            area = float(a[live].sum())
            if use_elastic:
                est, extra_kbits, _ = elastic_mod.update_host(
                    self.cfg.elastic, est, area, W_t, self.tau_wl,
                    self.tau_wh, reset_debt=bool(reconnect))
                extra = extra_kbits / cfgc.slot_seconds
            util, best_res = alloc.build_utility_table(
                self.mlp, a, c, bitrates, cfgc.resolutions, lam)
            al = alloc.allocate_dp_host(util, best_res, bitrates,
                                        max(W_t + extra, 0.0), live=live,
                                        device=self.device)
            masks = roi.mask
        elif method == "jcab":
            util, best_res = self._jcab_utility_table()
            al = alloc.allocate_dp_host(util, best_res, bitrates, W_t,
                                        live=live, device=self.device)
        elif method in ("reducto", "static"):
            al = alloc.allocate_fair_host(bitrates, W_t, C, live=live)
        else:
            raise ValueError(method)
        return (al.bitrates_kbps, al.resolutions, masks, extra, area,
                float(al.bitrates_kbps.sum()), est)

    # -- runners ----------------------------------------------------------------

    def _check_scene(self, scene, device_only: bool = False) -> None:
        """``run()`` takes a ``DeviceScene`` on the system's device with
        its GT capacity, or a host ``MultiCameraScene`` of the system's
        camera count; ``run_episode`` (``device_only``) a ``DeviceScene``
        only, since the episode synthesises the segments on the device."""
        if isinstance(scene, MultiCameraScene) and not device_only:
            if scene.cfg.num_cameras != self.cfg.scene.num_cameras:
                raise ValueError(f"scene has {scene.cfg.num_cameras} "
                                 f"cameras, the system "
                                 f"{self.cfg.scene.num_cameras}")
            return
        if not isinstance(scene, DeviceScene):
            kinds = ("a DeviceScene" if device_only
                     else "a DeviceScene or a MultiCameraScene")
            raise TypeError(f"this runner needs {kinds}, got "
                            f"{type(scene)!r}")
        if scene.device != self.device:
            raise ValueError(f"scene lives on {scene.device}, the system on "
                             f"{self.device}")
        if scene.G != self._G:
            raise ValueError(f"scene GT capacity {scene.G} != {self._G}")

    def run(self, scene, trace_kbps: np.ndarray,
            method: str = "deepstream", use_elastic: Optional[bool] = None,
            faults: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """One bandwidth trace through the configured runner, on a
        ``DeviceScene`` or a host ``MultiCameraScene`` (the episode runner
        takes a ``DeviceScene`` only).  ``faults`` is an optional (T, C)
        bool liveness mask (batched and episode runners only).  Returns
        per-slot logs keyed like the JAX package's."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        if use_elastic is None:
            use_elastic = method == "deepstream"
        if faults is not None:
            faults = np.asarray(faults, bool)
            T, C = len(trace_kbps), self.cfg.scene.num_cameras
            if faults.shape != (T, C):
                raise ValueError(f"faults mask must be (T={T}, C={C}), got "
                                 f"{faults.shape}")
            if not faults.any(axis=1).all():
                raise ValueError("faults mask leaves a slot with zero live "
                                 "cameras")
        if self.cfg.episode:
            return self.run_episode(scene, trace_kbps, method, use_elastic,
                                    faults=faults)
        self._check_scene(scene)
        if self.cfg.batched:
            return self._run_batched(scene, trace_kbps, method, use_elastic,
                                     faults=faults)
        if faults is not None:
            raise NotImplementedError("fault injection needs the batched or "
                                      "episode runner (batched=True)")
        return self._run_sequential(scene, trace_kbps, method, use_elastic)

    def _run_batched(self, scene, trace_kbps: np.ndarray,
                     method: str, use_elastic: bool,
                     faults: Optional[np.ndarray] = None,
                     carry: Optional[EpisodeCarry] = None
                     ) -> Dict[str, np.ndarray]:
        """The fleet slot loop.  Device control: the host fetches slot t's
        (2, C) and (4,) packs, after slot t+1 is dispatched when
        ``pipeline`` is on.  Host control: one (2, C) harvest per slot plus
        deepstream's (a, c) fetch.  ``carry`` (device control only) seeds
        the run as it seeds ``run_episode``, and every device-control run
        records ``last_carry``.  A checked run reads each slot's flags
        with its control pack (host control: one more fetch) and raises
        at that slot's harvest."""
        lam = self.cfg.lam()
        C = self.cfg.scene.num_cameras
        dev = self.device
        device_ctrl = self.cfg.alloc == "device"
        if carry is not None and not device_ctrl:
            raise ValueError("carry-seeded runs need alloc='device' (the "
                             "host control path has no device carry)")
        est = HostElasticState()
        t_begin = getattr(scene, "_t", 0)
        ctx = (self._control_context(method, trace_kbps, use_elastic)
               if device_ctrl else None)
        if carry is not None:
            ctx["est"] = carry.est
        tables = self._tables
        cam_ids = torch.arange(C, device=dev)
        logs: Dict[str, List[float]] = {k: [] for k in LOG_KEYS}
        checked = self.cfg.checked
        checks = ((fleet_mod.CONTROL_CHECKS if device_ctrl else ())
                  + fleet_mod.SLOT_CHECKS)

        def harvest(item) -> None:
            out, cpack = item
            pack = _d2h(out.host_pack, "harvest")
            logs["utility"].append(float(np.dot(lam, pack[0])))
            logs["mean_f1"].append(float(np.mean(pack[0])))
            logs["bytes"].append(float(np.sum(pack[1])))
            if cpack is not None:
                cp = _d2h(cpack, "harvest")
                logs["extra"].append(float(cp[0]))
                logs["area"].append(float(cp[1]))
                logs["alloc_kbps"].append(float(cp[2]))
                flags = cp[4:]
            elif checked:
                flags = _d2h(out.flags, "harvest")
            if checked:
                fleet_mod.raise_failed(flags[None], checks)

        self._reducto_ref = None if carry is None else carry.ref
        # the liveness mask goes up once per run; per slot the fault
        # signals are derived on the device (host control reads the mask)
        live_np = (np.ones((len(trace_kbps), C), bool) if faults is None
                   else faults)
        live_np0 = (np.ones(C, bool) if carry is None
                    else np.asarray(carry.live_prev, bool))
        live_tr = upload(live_np, dev, bool)
        live_prev = upload(live_np0, dev, bool)
        pending = None
        for t in range(len(trace_kbps)):
            W_t = float(trace_kbps[t])
            seg = scene.segment()
            # a DeviceScene's frames and padded GT are on the device; a host
            # scene's frames go up here once and its GT in the dispatch
            frames = self._frames_of(seg)
            gt_dev = seg.get("gt_dev")
            keys = fleet_mod.slot_camera_keys(self._key, seg["t"], cam_ids)
            live_t = live_tr[t]
            reconnect = live_t & ~live_prev
            if device_ctrl:
                b, r, masks, cpack = self._slot_control_device(
                    method, frames, t, ctx, use_elastic, live=live_t,
                    reconnect=reconnect.any(), tables=tables)
            else:
                rejoin = t > 0 and bool((live_np[t] & ~live_np[t - 1]).any())
                b, r, masks, extra, area, alloc_kbps, est = \
                    self._slot_allocation(method, frames, W_t, est,
                                          use_elastic, live=live_np[t],
                                          reconnect=rejoin)
                cpack = None
                logs["extra"].append(extra)
                logs["area"].append(area)
                logs["alloc_kbps"].append(alloc_kbps)
            keep = None
            if method == "reducto":
                # a carried run's reference is live: only reconnecting
                # cameras re-seed it
                keep = self._reducto_keep(
                    frames, reconnect | (t == 0 and carry is None))
            out = self._slot_dispatch(
                frames, None if gt_dev is not None else seg["boxes"], masks,
                b, r, keys=keys, live=live_t, tables=tables, keep=keep,
                gt_dev=gt_dev, checked=checked)
            if checked and cpack is not None:
                cpack = torch.cat([cpack, out.flags])
            live_prev = live_t
            logs["W"].append(W_t)
            if pending is not None:
                harvest(pending)
            if self.cfg.pipeline:
                pending = (out, cpack)
            else:
                harvest((out, cpack))
        if pending is not None:
            harvest(pending)
        if device_ctrl:
            ref = self._reducto_ref
            if ref is None:     # non-reducto: the reference passes through
                ref = (carry.ref if carry is not None else torch.zeros(
                    (C, self.cfg.scene.height, self.cfg.scene.width),
                    dtype=torch.float32, device=dev))
            self.last_carry = EpisodeCarry(
                est=ctx["est"], ref=ref,
                live_prev=(live_np[-1].copy() if len(trace_kbps)
                           else live_np0),
                t_first=carry.t_first if carry is not None else t_begin)
        return {k: np.asarray(v) for k, v in logs.items()}

    def _run_sequential(self, scene, trace_kbps: np.ndarray,
                        method: str, use_elastic: bool
                        ) -> Dict[str, np.ndarray]:
        """The per-camera reference loop with host control."""
        lam = self.cfg.lam()
        C = self.cfg.scene.num_cameras
        est = HostElasticState()
        cam_ids = torch.arange(C, device=self.device)
        logs: Dict[str, List[float]] = {k: [] for k in LOG_KEYS}
        self._reducto_ref_host = [None] * C
        for t in range(len(trace_kbps)):
            W_t = float(trace_kbps[t])
            seg = scene.segment()
            frames, gts = self._frames_of(seg), seg["boxes"]
            keys = fleet_mod.slot_camera_keys(self._key, seg["t"], cam_ids)
            b, r, masks, extra, area, alloc_kbps, est = self._slot_allocation(
                method, frames, W_t, est, use_elastic)
            if method == "reducto":
                f1s, sizes = self._reducto_slot(frames, gts, b, first=t == 0,
                                                keys=keys)
            else:
                f1s, sizes = self._encode_eval_all(frames, gts, masks, b, r,
                                                   keys)
            logs["extra"].append(extra)
            logs["area"].append(area)
            logs["alloc_kbps"].append(alloc_kbps)
            logs["utility"].append(float(np.dot(lam, f1s)))
            logs["mean_f1"].append(float(np.mean(f1s)))
            logs["bytes"].append(float(np.sum(sizes)))
            logs["W"].append(W_t)
        return {k: np.asarray(v) for k, v in logs.items()}

    def run_episode(self, scene: DeviceScene, trace_kbps: np.ndarray,
                    method: str = "deepstream",
                    use_elastic: Optional[bool] = None,
                    faults: Optional[np.ndarray] = None,
                    carry: Optional[EpisodeCarry] = None
                    ) -> Dict[str, np.ndarray]:
        """One whole bandwidth trace on the device, then one log fetch.
        ``faults`` is an optional (T, C) bool liveness mask.  Up to that
        fetch nothing waits on the card (``_episode_dispatch``).

        ``carry`` (the previous window's ``last_carry``) seeds the elastic
        state, the reducto reference, the previous liveness row and the
        stream's first slot, so that a chain of windows over one reused
        scene is slot for slot one run over the concatenated trace.  Every
        call records its own final carry on ``last_carry``."""
        out = self._episode_dispatch(scene, trace_kbps, method, use_elastic,
                                     faults, carry)
        return self._episode_logs(out, trace_kbps)

    def _episode_kwargs(self, scene: DeviceScene, trace_kbps: np.ndarray,
                        method: str, use_elastic: Optional[bool] = None,
                        faults: Optional[np.ndarray] = None,
                        carry: Optional[EpisodeCarry] = None
                        ) -> Dict[str, Any]:
        """The keyword arguments of ``fleet.fleet_episode`` (and of
        ``fleet.episode_inputs``) for an episode of ``scene`` from its
        cursor: the run's uploads (through pinned memory) and statics."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}")
        if not (self.cfg.batched and self.cfg.alloc == "device"):
            raise ValueError("episode mode requires batched=True and "
                             "alloc='device'")
        if use_elastic is None:
            use_elastic = method == "deepstream"
        self._check_scene(scene, device_only=True)
        ctx = self._control_context(method, trace_kbps, use_elastic)
        if carry is not None:
            ctx["est"] = carry.est
        deep = method in ("deepstream", "deepstream_no_elastic")
        return dict(
            codec_cfg=self.cfg.codec, scene_cfg=scene.cfg,
            server_params=self.server, light_params=self.light,
            mlp_params=self.mlp if deep else None,
            jcab_util=ctx["jcab_util"], jcab_res=ctx["jcab_res"],
            lam=ctx["lam"], scene_params=scene.params, trace=ctx["trace"],
            key0=self._key, skey=scene.key, tau_wl=ctx["tau_wl"],
            tau_wh=ctx["tau_wh"], est0=ctx["est"], ecfg=self.cfg.elastic,
            bitrates=tuple(self.cfg.codec.bitrates_kbps),
            resolutions=tuple(self.cfg.codec.resolutions),
            use_elastic=use_elastic, w_cap=ctx["w_cap"],
            num_cams=self.cfg.scene.num_cameras,
            eval_frames=self.cfg.eval_frames, block_size=self.cfg.block_size,
            gt_pad=self._G, t_start=scene._t,
            buckets=self.cfg.episode_buckets, faults=faults,
            ref0=None if carry is None else carry.ref,
            live_prev0=None if carry is None else carry.live_prev,
            t_first=None if carry is None else carry.t_first,
            pipelined=self.cfg.episode_pipelined, checked=self.cfg.checked)

    def _episode_dispatch(self, scene: DeviceScene, trace_kbps: np.ndarray,
                          method: str, use_elastic: Optional[bool] = None,
                          faults: Optional[np.ndarray] = None,
                          carry: Optional[EpisodeCarry] = None,
                          _eager: bool = False) -> fleet_mod.EpisodeOut:
        """``run_episode`` up to its harvest: the run's uploads (through
        pinned memory), ``fleet.fleet_episode``, the scene cursor and
        ``last_carry``; returns the device logs.  On a warm configuration
        nothing here waits on the card.  ``_eager`` runs the slot loop
        eagerly on the card (for comparison with the graph only)."""
        kw = self._episode_kwargs(scene, trace_kbps, method, use_elastic,
                                  faults, carry)
        C = self.cfg.scene.num_cameras
        t_begin = scene._t
        out = fleet_mod.fleet_episode(method, **kw, _eager=_eager)
        scene._t += len(trace_kbps)
        self.last_carry = EpisodeCarry(
            est=out.est, ref=out.ref,
            # audit: allow(host-sync) faults is the caller's host mask
            live_prev=(np.asarray(faults[-1], bool) if faults is not None
                       else np.ones(C, bool)),
            t_first=carry.t_first if carry is not None else t_begin)
        return out

    def _episode_logs(self, out: fleet_mod.EpisodeOut,
                      trace_kbps: np.ndarray) -> Dict[str, np.ndarray]:
        """The one harvest of an episode's stacked logs; a checked run
        raises here on the first violated check (``fleet.CheckError``)."""
        lam = self.cfg.lam()
        packs = _d2h(out.packs, "harvest")
        cpacks = _d2h(out.cpacks, "harvest")
        if cpacks.shape[1] > 4:
            fleet_mod.raise_failed(cpacks[:, 4:], fleet_mod.EPISODE_CHECKS,
                                   run_level=1)
        return {
            "utility": packs[:, 0] @ lam,
            "mean_f1": packs[:, 0].mean(axis=1),
            "bytes": packs[:, 1].sum(axis=1),
            "W": np.asarray(trace_kbps, float),
            "extra": cpacks[:, 0].astype(float),
            "area": cpacks[:, 1].astype(float),
            "alloc_kbps": cpacks[:, 2].astype(float),
        }


# -- watchdog-supervised runs ---------------------------------------------------

@dataclass
class SupervisorConfig:
    """Policy of ``EpisodeSupervisor``: ``max_retries`` re-dispatches of
    one run at a rung; ``backoff_s`` the base of an exponential retry
    backoff (0 = retry at once); ``degrade`` allows falling down the
    ladder when retries run out or the watchdog escalates;
    ``recover_after`` consecutive healthy runs at a degraded rung climb one
    rung back (0 = rungs stay degraded); ``watchdog`` the straggler gate
    fed with each run's wall time."""
    max_retries: int = 2
    backoff_s: float = 0.0
    degrade: bool = True
    recover_after: int = 3
    watchdog: ft_watchdog.WatchdogConfig = field(
        default_factory=ft_watchdog.WatchdogConfig)


class EpisodeSupervisor:
    """``DeepStreamSystem`` runs under bounded retry with backoff, a
    straggler watchdog on each run's wall time, and a degraded-mode ladder
    (the JAX package's, for an episode-mode system):

      ``episode``          the whole trace in one episode (CUDA graphs on
                           the card)
      ``episode_chunked``  the same episode per next-smaller-bucket chunk;
                           the elastic and reducto state re-seed at chunk
                           boundaries, the JAX package's documented
                           degraded-mode approximation
      ``pipelined``        the fleet slot loop (``_run_batched``)

    A run that raises is retried up to ``max_retries`` times at its rung,
    then the supervisor degrades one rung and retries there; a run whose
    wall time draws the watchdog's ``'replace'`` degrades the next run.
    Rungs stick across runs, and ``recover_after`` healthy runs at a
    degraded rung climb one back.  Every rung change rebaselines the
    watchdog.  Every decision is appended to ``events``.
    ``fault_hook(attempt=, mode=)`` runs before each dispatch; raising
    from it fails that attempt."""

    LADDER_EPISODE = ("episode", "episode_chunked", "pipelined")

    def __init__(self, system: DeepStreamSystem,
                 cfg: Optional[SupervisorConfig] = None,
                 fault_hook: Optional[Any] = None):
        self.system = system
        self.cfg = cfg if cfg is not None else SupervisorConfig()
        self.fault_hook = fault_hook
        self.watchdog = ft_watchdog.Watchdog(self.cfg.watchdog)
        self.events: List[Dict[str, Any]] = []
        self._step = 0          # watchdog step counter (successful runs)
        self._rung = 0          # position on the ladder
        self._ok_streak = 0     # consecutive healthy runs at a degraded rung

    @property
    def mode(self) -> str:
        return self._ladder()[min(self._rung, len(self._ladder()) - 1)]

    def _ladder(self) -> Tuple[str, ...]:
        if self.system.cfg.episode:
            return self.LADDER_EPISODE
        return ("pipelined",)

    def run(self, scene, trace_kbps: np.ndarray, method: str = "deepstream",
            use_elastic: Optional[bool] = None,
            faults: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """One supervised run; the signature and logs of
        ``DeepStreamSystem.run``."""
        ladder = self._ladder()
        last_err: Optional[BaseException] = None
        for rung in range(min(self._rung, len(ladder) - 1), len(ladder)):
            mode = ladder[rung]
            for attempt in range(self.cfg.max_retries + 1):
                if attempt and self.cfg.backoff_s > 0.0:
                    time.sleep(self.cfg.backoff_s * (2.0 ** (attempt - 1)))
                t0 = time.perf_counter()
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(attempt=attempt, mode=mode)
                    logs = self._dispatch(mode, scene, trace_kbps, method,
                                          use_elastic, faults)
                except Exception as e:   # the retry boundary
                    last_err = e
                    self.events.append({"kind": "retry", "mode": mode,
                                        "attempt": attempt,
                                        "error": repr(e)})
                    continue
                wall = time.perf_counter() - t0
                self._step += 1
                verdict = self.watchdog.record(self._step, wall)
                self.events.append({"kind": "ok", "mode": mode,
                                    "attempt": attempt, "wall_s": wall,
                                    "verdict": verdict})
                if (verdict == "replace" and self.cfg.degrade
                        and rung + 1 < len(ladder)):
                    # sustained straggling: degrade the NEXT run
                    self._rung = rung + 1
                    self._ok_streak = 0
                    self.watchdog.rebaseline()
                    self.events.append({"kind": "degrade", "mode": mode,
                                        "to": ladder[self._rung],
                                        "cause": "watchdog"})
                elif (verdict == "ok" and rung > 0
                        and self.cfg.recover_after > 0):
                    self._ok_streak += 1
                    if self._ok_streak >= self.cfg.recover_after:
                        self._rung = rung - 1
                        self._ok_streak = 0
                        self.watchdog.rebaseline()
                        self.events.append({"kind": "recover", "mode": mode,
                                            "to": ladder[self._rung],
                                            "after_ok":
                                                self.cfg.recover_after})
                else:
                    self._ok_streak = 0
                return logs
            if self.cfg.degrade and rung + 1 < len(ladder):
                self._rung = rung + 1
                self._ok_streak = 0
                self.watchdog.rebaseline()
                self.events.append({"kind": "degrade", "mode": mode,
                                    "to": ladder[self._rung],
                                    "cause": "retries_exhausted"})
            else:
                break
        raise RuntimeError(
            f"supervised run failed at every mode rung (last mode "
            f"{self.mode!r}, {self.cfg.max_retries} retries each)"
        ) from last_err

    def _dispatch(self, mode: str, scene, trace_kbps: np.ndarray, method: str,
                  use_elastic: Optional[bool],
                  faults: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
        if use_elastic is None:
            use_elastic = method == "deepstream"
        if mode == "episode":
            return self.system.run_episode(scene, trace_kbps, method,
                                           use_elastic, faults=faults)
        if mode == "episode_chunked":
            return self._run_chunked(scene, trace_kbps, method, use_elastic,
                                     faults)
        if mode == "pipelined":
            return self.system._run_batched(scene, trace_kbps, method,
                                            use_elastic, faults=faults)
        raise ValueError(mode)

    def _chunk_len(self, T: int) -> int:
        """The degraded chunk: the bucket below the one a T-slot episode
        uses, floored at the smallest bucket (T // 2 without buckets)."""
        buckets = self.system.cfg.episode_buckets
        if not buckets:
            return max(1, T // 2)
        below = [b for b in sorted(buckets)
                 if b < fleet_mod.bucket_len(T, buckets)]
        return below[-1] if below else sorted(buckets)[0]

    def _run_chunked(self, scene, trace_kbps: np.ndarray, method: str,
                     use_elastic: bool, faults: Optional[np.ndarray]
                     ) -> Dict[str, np.ndarray]:
        """The episode per chunk of the trace, each chunk a fresh run (no
        carry), as the JAX package's ``_run_chunked``."""
        T = len(trace_kbps)
        step = self._chunk_len(T)
        parts: List[Dict[str, np.ndarray]] = []
        for i0 in range(0, T, step):
            i1 = min(i0 + step, T)
            parts.append(self.system.run_episode(
                scene, np.asarray(trace_kbps)[i0:i1], method, use_elastic,
                faults=None if faults is None else faults[i0:i1]))
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
