"""Whole-trace fleet episode: synthesis -> ROIDet -> control -> keep ->
encode -> detect -> score, slot by slot, for every method.

The counterpart of ``repro.core.fleet``'s reference episode body
(``_episode_impl`` with ``pipelined=False``).  Method routing follows the
JAX package:

  * deepstream — ROI masks and (a, c) features from ROIDet, elastic
    adjustment, utility-MLP table, knapsack DP;
  * jcab — full frames, the content-agnostic table, knapsack DP;
  * reducto — full frames, equal share, traced keep-flags from the
    edge-motion kernel against a cross-slot reference frame, detections of
    the last kept frame reused for the filtered ones;
  * static — full frames, equal share.

Every per-camera operand stays on the device; the per-slot logs are
stacked there and fetched once by the caller.  The liveness mask
(``faults``) rides through as data: a dead camera computes but transmits
nothing, is excluded from the allocators and the area signal, and rejoins
as fresh (reducto reference re-seeded, elastic debt cleared).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.core import allocation as alloc_mod
from repro_torch.core import codec as codec_mod
from repro_torch.core import elastic as elastic_mod
from repro_torch.core import roidet as roidet_mod
from repro_torch.core import utility as util_mod
from repro_torch.core.codec import CodecConfig
from repro_torch.core.elastic import ElasticConfig, ElasticState
from repro_torch.data import synthetic as synth_mod
from repro_torch.data.synthetic import DeviceSceneParams, SceneConfig
from repro_torch.kernels.edge_motion import ops as em_ops
from repro_torch.models import detector as det

# block-motion mass above which a frame counts as "changed" (reducto)
MOTION_KEEP_THRESH = 25.0

# domain-separation salt for the codec key stream
CODEC_KEY_SALT = 0x0DEC

Params = Dict[str, torch.Tensor]


def slot_camera_keys(key0: torch.Tensor, t: int,
                     cam_ids: torch.Tensor) -> torch.Tensor:
    """Per-(slot, camera) codec keys, ``fold_in(fold_in(fold_in(key0,
    salt), t), cam_id)``: camera i's noise does not depend on which other
    cameras exist -> (C, 2)."""
    kt = prng.fold_in(prng.fold_in(key0, CODEC_KEY_SALT), int(t))
    return prng.fold_in(kt, cam_ids.to(torch.int64))


class KeepSelection(NamedTuple):
    n_eff: torch.Tensor     # (C,) f32 kept-frame counts (codec charge)
    eval_idx: torch.Tensor  # (C, F) kept frames scored for F1
    eval_w: torch.Tensor    # (C, F) f32 per-frame weights (rows sum to 1)
    reuse_idx: torch.Tensor # (C,) last kept frame (the reuse detection)
    miss_idx: torch.Tensor  # (C, F) filtered-out frames the reuse scores
    miss_w: torch.Tensor    # (C, F) f32 (all-zero rows = arm inert)
    w_keep: torch.Tensor    # (C,) f32 arm mix (1 = reuse arm off)


def _linspace_sel(count: torch.Tensor, F: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min(F, count) evenly spaced positions over a length-``count`` list
    (integer form of ``np.linspace(0, n-1, f).astype(int)``), padded by
    repeating the last -> (positions (C, F), f_eff (C,))."""
    j = torch.arange(F, device=count.device)[None, :]
    count = torch.clamp(count.to(torch.int64), min=1)[:, None]
    f_eff = torch.clamp(count, max=F)
    jj = torch.minimum(j, f_eff - 1)
    pos = (jj * (count - 1)) // torch.clamp(f_eff - 1, min=1)
    return pos, f_eff[:, 0]


def keep_selection(keep: torch.Tensor, F: int) -> KeepSelection:
    """keep (C, N) bool (>= 1 True per row) -> the slot's frame selection;
    an all-True row gives the plain eval spread with the reuse arm off."""
    C, N = keep.shape
    if N > 128 or F > 10:
        raise ValueError(f"keep_selection supports N <= 128, F <= 10: {N}, "
                         f"{F}")
    k8 = keep.to(torch.uint8)
    kept_pos = torch.argsort(1 - k8, dim=1, stable=True)  # kept first
    miss_pos = torch.argsort(k8, dim=1, stable=True)      # missed first
    m = keep.sum(dim=1)
    n_miss = N - m
    ev_p, f_eff = _linspace_sel(m, F)
    eval_idx = torch.gather(kept_pos, 1, ev_p)
    j = torch.arange(F, device=keep.device)[None, :]
    eval_w = torch.where(j < f_eff[:, None],
                         1.0 / torch.clamp(f_eff[:, None], min=1), 0.0)
    ms_p, fm_eff = _linspace_sel(n_miss, F)
    miss_idx = torch.gather(miss_pos, 1, ms_p)
    miss_w = torch.where((j < fm_eff[:, None]) & (n_miss[:, None] > 0),
                         1.0 / torch.clamp(fm_eff[:, None], min=1), 0.0)
    reuse_idx = torch.gather(kept_pos, 1,
                             torch.clamp(m - 1, min=0)[:, None])[:, 0]
    return KeepSelection(
        n_eff=m.to(torch.float32), eval_idx=eval_idx,
        eval_w=eval_w.to(torch.float32), reuse_idx=reuse_idx,
        miss_idx=miss_idx, miss_w=miss_w.to(torch.float32),
        w_keep=keep.to(torch.float32).sum(dim=1) / float(N))


class SlotStaged(NamedTuple):
    batch: torch.Tensor             # (C*F [+ C], H, W) detector input
    gt_e: torch.Tensor              # (C, F, G, 4) eval-frame ground truth
    gv_e: torch.Tensor              # (C, F, G)
    gt_m: Optional[torch.Tensor]    # (C, F, G, 4) missed-frame GT
    gv_m: Optional[torch.Tensor]    # (C, F, G)
    eval_w: torch.Tensor
    miss_w: torch.Tensor
    w_keep: torch.Tensor
    sizes: torch.Tensor             # (C,) encoded bytes (pre tx-mask)
    tx: torch.Tensor                # (C,) bool: live & b > 0


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (C, N, ...), idx (C, F) -> x[c, idx[c, f]] (C, F, ...)."""
    ci = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[ci, idx]


def _slot_encode(cfg: CodecConfig, frames: torch.Tensor, masks: torch.Tensor,
                 b: torch.Tensor, r: torch.Tensor, keys: torch.Tensor,
                 keep: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_valid: torch.Tensor, live: torch.Tensor, *,
                 eval_frames: int, block_size: int,
                 with_reuse: bool) -> SlotStaged:
    """Crop -> fleet encode (tx_codec kernel) -> eval-frame gather ->
    detector batch (+ the reuse row and GT gathers)."""
    C, N, H, W = frames.shape
    F = min(eval_frames, N)
    sel = keep_selection(keep, F)
    cropped = roidet_mod.crop_to_mask(frames, masks, block_size)
    roi_pixels = (masks.sum(dim=(1, 2)) * block_size ** 2).to(torch.float32)
    decoded, sizes = codec_mod.encode_fleet_segment(
        cfg, cropped, roi_pixels, b, r, keys, sel.n_eff)
    batch = _rows(decoded, sel.eval_idx).reshape(C * F, H, W)
    gt_e, gv_e = _rows(gt_boxes, sel.eval_idx), _rows(gt_valid, sel.eval_idx)
    gt_m = gv_m = None
    if with_reuse:
        # reuse frames are RAW camera frames, folded into the same forward
        reuse_fr = _rows(frames, sel.reuse_idx[:, None])[:, 0]
        batch = torch.cat([batch, reuse_fr], dim=0)
        gt_m = _rows(gt_boxes, sel.miss_idx)
        gv_m = _rows(gt_valid, sel.miss_idx)
    return SlotStaged(batch=batch, gt_e=gt_e, gv_e=gv_e, gt_m=gt_m,
                      gv_m=gv_m, eval_w=sel.eval_w, miss_w=sel.miss_w,
                      w_keep=sel.w_keep, sizes=sizes, tx=live & (b > 0.0))


class FleetSlotOut(NamedTuple):
    f1: torch.Tensor         # (C,) final per-camera F1 (reuse-arm mixed)
    sizes: torch.Tensor      # (C,) encoded bytes
    host_pack: torch.Tensor  # (2, C) [f1; sizes], the one per-slot fetch


def _slot_finish(server_params: Params, st: SlotStaged, *,
                 conf_thresh: float, with_reuse: bool) -> FleetSlotOut:
    """Server detector -> box decode -> greedy F1 of both arms -> the
    tx-masked outputs and their (2, C) [f1; sizes] log pack."""
    C, F, G = st.gt_e.shape[:3]
    grid = det.forward(server_params, st.batch)
    boxes, _, valid = det.decode_boxes(grid, conf_thresh=conf_thresh)
    f1_frames = det.f1_score_batch(
        boxes[:C * F], valid[:C * F], st.gt_e.reshape(C * F, G, 4),
        st.gv_e.reshape(C * F, G)).reshape(C, F)
    f1 = (f1_frames * st.eval_w).sum(dim=1)
    if with_reuse:
        rb = boxes[C * F:].repeat_interleave(F, dim=0)
        rv = valid[C * F:].repeat_interleave(F, dim=0)
        f1_miss = det.f1_score_batch(
            rb, rv, st.gt_m.reshape(C * F, G, 4),
            st.gv_m.reshape(C * F, G)).reshape(C, F)
        f1 = (f1 * st.w_keep
              + (f1_miss * st.miss_w).sum(dim=1) * (1.0 - st.w_keep))
    f1 = torch.where(st.tx, f1, 0.0)
    sizes = torch.where(st.tx, st.sizes, 0.0)
    return FleetSlotOut(f1=f1, sizes=sizes,
                        host_pack=torch.stack([f1, sizes]))


def fleet_slot_step(cfg: CodecConfig, server_params: Params,
                    frames: torch.Tensor, masks: torch.Tensor,
                    b: torch.Tensor, r: torch.Tensor, keys: torch.Tensor,
                    keep: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_valid: torch.Tensor, live: torch.Tensor, *,
                    eval_frames: int, block_size: int, with_reuse: bool,
                    conf_thresh: float = 0.4) -> FleetSlotOut:
    """One slot of every method: ``_slot_encode`` then ``_slot_finish``.
    frames (C, N, H, W); masks (C, H/bs, W/bs) bool; b, r (C,); keys
    (C, 2); keep (C, N) bool (all True except for reducto); GT for all N
    frames; live (C,) bool.  ``with_reuse`` adds reducto's reuse arm."""
    st = _slot_encode(cfg, frames, masks, b, r, keys, keep, gt_boxes,
                      gt_valid, live, eval_frames=eval_frames,
                      block_size=block_size, with_reuse=with_reuse)
    return _slot_finish(server_params, st, conf_thresh=conf_thresh,
                        with_reuse=with_reuse)


def reducto_keep_step(frames: torch.Tensor, ref: torch.Tensor,
                      first: torch.Tensor, *, block_size: int,
                      edge_thresh: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reducto keep decision with a cross-slot reference: frame 0 against
    the last kept frame of the previous slot, frames 1..N-1 against their
    predecessor, through the edge-motion kernel over (C, N+1) frames.
    ``first`` (C,) marks run start / reconnect (reference re-seeded, frame
    0 forced kept); an all-quiet slot keeps frame 0.  Returns (keep (C, N),
    new reference (C, H, W))."""
    C, N = frames.shape[:2]
    ref = torch.where(first[:, None, None], frames[:, 0], ref)
    allf = torch.cat([ref[:, None], frames], dim=1)
    sc = em_ops.segment_motion_fleet(allf, block_size=block_size,
                                     edge_thresh=edge_thresh)  # (C, N, M, Nb)
    raw = sc.sum(dim=(2, 3)) > MOTION_KEEP_THRESH
    keep = raw.clone()
    keep[:, 0] = raw[:, 0] | first | ~raw.any(dim=1)
    last = (N - 1) - torch.argmax(keep.flip(1).to(torch.uint8), dim=1)
    return keep, _rows(frames, last[:, None])[:, 0]


class ControlOut(NamedTuple):
    b: torch.Tensor         # (C,) assigned bitrates (Kbps)
    r: torch.Tensor         # (C,) assigned resolutions
    est: ElasticState
    pack: torch.Tensor      # (4,) [extra_kbps, area, alloc_kbps, feasible]


def fleet_control_step(mlp_params: Optional[Params], jcab_util, jcab_res,
                       lam, a, c, W_t: torch.Tensor, est: ElasticState,
                       tau_wl, tau_wh, live: torch.Tensor,
                       reconnect: torch.Tensor, *, method: str,
                       ecfg: ElasticConfig, bitrates: Tuple[int, ...],
                       resolutions: Tuple[float, ...], slot_seconds: float,
                       use_elastic: bool, w_cap: int,
                       num_cams: int) -> ControlOut:
    """One slot of the server-side control loop: elastic adjustment ->
    utility table -> allocation, routed by method, left on the device.
    ``a``/``c`` are None for the content-agnostic methods; ``live`` (C,)
    and ``reconnect`` (0-d) are bool tensors.  The effective capacity floor
    is 0 (a hard-outage slot allocates nothing)."""
    dev = W_t.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if method in ("deepstream", "deepstream_no_elastic"):
        area = torch.where(live, a, 0.0).sum()
        extra = zero
        if use_elastic:
            est, extra_kbits = elastic_mod.update(
                ecfg, est, area, W_t, tau_wl, tau_wh, reset_debt=reconnect)
            extra = extra_kbits / slot_seconds
        util, best_res = util_mod.utility_table(
            mlp_params, a, c,
            torch.tensor(bitrates, dtype=torch.float32, device=dev),
            torch.tensor(resolutions, dtype=torch.float32, device=dev), lam)
        W_eff = torch.clamp(W_t + extra, min=0.0)
        _, b, r, _, feasible = alloc_mod.allocate_dp(
            util, best_res, bitrates, W_eff, w_cap=w_cap, live=live)
    elif method == "jcab":
        area = extra = zero
        _, b, r, _, feasible = alloc_mod.allocate_dp(
            jcab_util, jcab_res, bitrates, W_t, w_cap=w_cap, live=live)
    elif method in ("reducto", "static"):
        area = extra = zero
        b, feasible = alloc_mod.allocate_fair(bitrates, W_t, num_cams,
                                              live=live)
        r = torch.ones((num_cams,), dtype=torch.float32, device=dev)
    else:
        raise ValueError(method)
    pack = torch.stack([extra, area, b.sum(), feasible.to(torch.float32)])
    return ControlOut(b=b, r=r, est=est, pack=pack)


class EpisodeOut(NamedTuple):
    packs: torch.Tensor     # (T, 2, C) stacked [f1; sizes] per slot
    cpacks: torch.Tensor    # (T, 4) [extra, area, alloc_kbps, feasible]


def fleet_episode(method: str, *, codec_cfg: CodecConfig,
                  scene_cfg: SceneConfig, server_params: Params,
                  light_params: Params, mlp_params: Optional[Params],
                  jcab_util, jcab_res, lam: torch.Tensor,
                  scene_params: DeviceSceneParams, trace: torch.Tensor,
                  key0: torch.Tensor, skey: torch.Tensor, tau_wl, tau_wh,
                  est0: ElasticState, ecfg: ElasticConfig,
                  bitrates: Tuple[int, ...], resolutions: Tuple[float, ...],
                  use_elastic: bool, w_cap: int, num_cams: int,
                  eval_frames: int, block_size: int,
                  conf_thresh: float = 0.4, gt_pad: int = 16,
                  t_start: int = 0,
                  faults: Optional[np.ndarray] = None) -> EpisodeOut:
    """Run a whole bandwidth trace (``trace`` (T,) f32 on the device) and
    return the stacked logs, still on the device.  ``faults`` is the
    optional (T, C) bool liveness mask (True = live)."""
    N, H, W = (scene_cfg.frames_per_segment, scene_cfg.height,
               scene_cfg.width)
    dev = trace.device
    T = int(trace.shape[0])
    if faults is None:
        live_np = np.ones((T, num_cams), bool)
    else:
        live_np = np.asarray(faults, bool)
        if live_np.shape != (T, num_cams):
            raise ValueError(f"faults mask must be (T={T}, C={num_cams}) "
                             f"bool, got {live_np.shape}")
        if not live_np.any(axis=1).all():
            raise ValueError("faults mask leaves a slot with zero live "
                             "cameras — the control step needs >= 1")
    live_tr = torch.as_tensor(live_np, device=dev)
    with_reuse = method == "reducto"
    est = est0
    ref = torch.zeros((num_cams, H, W), dtype=torch.float32, device=dev)
    live_prev = torch.ones((num_cams,), dtype=torch.bool, device=dev)
    packs, cpacks = [], []
    for i in range(T):
        t = t_start + i
        W_t, live_t = trace[i], live_tr[i]
        frames, gtb, gtv = synth_mod.segments_device(
            scene_cfg, scene_params, skey, t, gt_pad=gt_pad)
        keys = slot_camera_keys(key0, t, scene_params.cam_ids)
        reconnect = live_t & ~live_prev
        a = c = None
        if method in ("deepstream", "deepstream_no_elastic"):
            roi = roidet_mod.roidet_fleet(frames, light_params,
                                          block_size=block_size)
            masks, a, c = roi.mask, roi.area_ratio, roi.confidence
        else:
            masks = roidet_mod.full_frame_mask(num_cams, H, W, block_size,
                                               dev)
        co = fleet_control_step(
            mlp_params, jcab_util, jcab_res, lam, a, c, W_t, est, tau_wl,
            tau_wh, live_t, reconnect.any(), method=method, ecfg=ecfg,
            bitrates=bitrates, resolutions=resolutions,
            slot_seconds=codec_cfg.slot_seconds, use_elastic=use_elastic,
            w_cap=w_cap, num_cams=num_cams)
        if method == "reducto":
            first = reconnect | (t == t_start)
            keep, ref = reducto_keep_step(
                frames, ref, first, block_size=block_size,
                edge_thresh=roidet_mod.EDGE_THRESH)
        else:
            keep = torch.ones((num_cams, N), dtype=torch.bool, device=dev)
        packs.append(fleet_slot_step(
            codec_cfg, server_params, frames, masks, co.b, co.r, keys, keep,
            gtb, gtv, live_t, eval_frames=eval_frames, block_size=block_size,
            with_reuse=with_reuse, conf_thresh=conf_thresh).host_pack)
        cpacks.append(co.pack)
        est, live_prev = co.est, live_t
    return EpisodeOut(packs=torch.stack(packs), cpacks=torch.stack(cpacks))


def eval_indices(n: int, eval_frames: int) -> np.ndarray:
    """The sequential runner's scored-frame selection: min(F, n) evenly
    spaced frames of n."""
    return np.linspace(0, n - 1, min(eval_frames, n)).astype(int)


def gt_capacity(max_boxes_per_frame: int, min_boxes: int = 16) -> int:
    """Fixed GT padding G for a scene: the smallest multiple of 8 >=
    max(min_boxes, max_boxes_per_frame)."""
    return max(min_boxes, -(-max_boxes_per_frame // 8) * 8)
