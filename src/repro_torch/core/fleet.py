"""Whole-trace fleet episode: synthesis -> ROIDet -> control -> keep ->
encode -> detect -> score, slot by slot, for every method.

The counterpart of ``repro.core.fleet``'s episode (``_episode_impl`` and
``fleet_episode``).  Method routing follows the JAX package:

  * deepstream (and deepstream_no_elastic, without the elastic update) —
    ROI masks and (a, c) features from ROIDet, elastic adjustment,
    utility-MLP table, knapsack DP;
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

A slot is ``slot_front`` (synthesis to the staged detector batch) then
``_slot_finish`` (detector to the log pack).  The reference body runs them
back to back; the pipelined body (the default) runs slot i's front beside
slot i-1's finish, with each slot's live cameras compacted to the leading
rows, and its logs equal the reference body's bitwise.  On the card the
slot step is captured once per (method, configuration, trace bucket) as a
CUDA graph and replayed for every slot: the counterpart of the JAX
package's one compiled program per (method, bucket).  Nothing in a slot
step reads the device from the host.

The ``checked`` diagnostics lane (``SystemConfig.checked``) computes the
JAX package's checkify invariants on the device, as a row of violation
flags beside each slot's control pack (``CONTROL_CHECKS``,
``SLOT_CHECKS``, ``EPISODE_CHECKS``): finite logs, F1 in [0, 1], no dead
camera granted bandwidth, a feasible allocation within the slot's
capacity, the elastic debt within its budget.  The rows ride the CUDA
graphs and the harvest's fetch; ``raise_failed`` raises the first violated
check in program order with the JAX package's message (``CheckError``)
after the harvest, so a checked run keeps the episode's one harvest.  An
unchecked run computes no flags (``checked`` is part of the graph key).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import prng
from repro_torch.common.device import upload
from repro_torch.core import allocation as alloc_mod
from repro_torch.core import codec as codec_mod
from repro_torch.core import elastic as elastic_mod
from repro_torch.core import roidet as roidet_mod
from repro_torch.core import utility as util_mod
from repro_torch.core.codec import CodecConfig, CodecTables
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

# -- the checked diagnostics lane ---------------------------------------------
# The JAX package's checkify messages, in its program order.

CONTROL_CHECKS: Tuple[str, ...] = (
    "control: elastic debt outside [0, budget]",
    "control: no live camera in slot",
    "control: bandwidth sample not finite/non-negative",
    "control: non-finite allocation or log pack",
    "control: dead camera granted bandwidth",
    "control: feasible allocation exceeds slot capacity",
)
SLOT_CHECKS: Tuple[str, ...] = (
    "slot-step: non-finite F1 or size",
    "slot-step: F1 outside [0, 1]",
    "slot-step: negative size",
    "slot-step: keep mask row with no kept frame",
    "slot-step: non-transmitting camera produced F1",
)
# an episode slot's flag row: the trace check (reduced over the run, since
# the JAX package checks the whole trace before its scan), the control
# checks, then the reference body's F1 check
EPISODE_CHECKS: Tuple[str, ...] = (
    ("episode: non-finite bandwidth trace",) + CONTROL_CHECKS
    + ("episode slot-step: non-finite F1 or size",))


class CheckError(ValueError):
    """A checked run violated an invariant (the counterpart of checkify's
    ``JaxRuntimeError``); the message is the JAX package's."""


def raise_failed(flags: np.ndarray, messages: Sequence[str],
                 run_level: int = 0) -> None:
    """Raise ``CheckError`` for the first violated check of ``flags`` ((T,
    K) violation flags, the columns in ``messages``' order) in program
    order: the first ``run_level`` columns are checks of the whole run
    (any slot), then slot by slot, column by column."""
    flags = np.asarray(flags) > 0
    for k in range(run_level):
        if flags[:, k].any():
            raise CheckError(messages[k])
    for row in flags:
        for k in range(run_level, len(messages)):
            if row[k]:
                raise CheckError(messages[k])


def _violated(*ok: torch.Tensor) -> torch.Tensor:
    """(len(ok),) f32 flags: 1 where a check's 0-d bool condition fails."""
    return (~torch.stack([o.reshape(()) for o in ok])).to(torch.float32)


# default trace-length buckets of the episode: one CUDA graph per (method,
# configuration, bucket) serves every trace length up to the bucket
EPISODE_BUCKETS: Tuple[int, ...] = (8, 16, 32)


def bucket_len(T: int, buckets: Optional[Sequence[int]] = EPISODE_BUCKETS
               ) -> int:
    """Padded trace length for a T-slot episode: the smallest bucket >= T,
    doubling the largest bucket until it covers T, or T itself when
    bucketing is disabled (``buckets`` falsy).

    Padded-slot contract: a padded slot cannot advance any observable
    episode state.  The elastic state, the reducto reference and the
    liveness row handed back are the last active slot's, the padded log
    rows never reach the host, and the DP capacity comes from the active
    trace (``allocation.trace_capacity`` runs before padding), so
    bucketing can never change a pick.  The JAX package runs padded slots
    and freezes the carry; the port does not run them at all (the host
    knows T), and the bucket sizes the captured graph's per-slot buffers,
    so one graph serves every T <= bucket."""
    T = int(T)
    if not buckets:
        return T
    bs = sorted(int(b) for b in buckets)
    if bs[0] < 1:
        raise ValueError(f"episode buckets must be >= 1: {buckets!r}")
    for b in bs:
        if T <= b:
            return b
    b = bs[-1]
    while b < T:
        b *= 2
    return b


def _key_chain(key: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n successive ``key, sub = split(key)`` steps on the key's device ->
    (the advanced key, the n subkeys stacked (n, 2)): the keys a host loop
    of ``split`` draws, in its order, with no read of the device."""
    subs = []
    # audit: allow(host-sync) n is a host int, the chain's length
    for _ in range(int(n)):
        key, sub = prng.split(key)
        subs.append(sub)
    stacked = (torch.stack(subs) if subs else
               torch.zeros((0, 2), dtype=key.dtype, device=key.device))
    return key, stacked


def slot_camera_keys(key0: torch.Tensor, t,
                     cam_ids: torch.Tensor) -> torch.Tensor:
    """Per-(slot, camera) codec keys, ``fold_in(fold_in(fold_in(key0,
    salt), t), cam_id)``: camera i's noise does not depend on which other
    cameras exist -> (C, 2).  ``t`` is the global slot index, a Python int
    or a 0-d integer tensor on the key's device."""
    kt = prng.fold_in(prng.fold_in(key0, CODEC_KEY_SALT), t)
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
                 eval_frames: int, block_size: int, with_reuse: bool,
                 tables: CodecTables) -> SlotStaged:
    """Crop -> fleet encode (tx_codec kernel) -> eval-frame gather ->
    detector batch (+ the reuse row and GT gathers)."""
    C, N, H, W = frames.shape
    F = min(eval_frames, N)
    sel = keep_selection(keep, F)
    cropped = roidet_mod.crop_to_mask(frames, masks, block_size)
    roi_pixels = (masks.sum(dim=(1, 2)) * block_size ** 2).to(torch.float32)
    decoded, sizes = codec_mod.encode_fleet_segment(
        cfg, cropped, roi_pixels, b, r, keys, sel.n_eff, tables=tables)
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
    f1_frames: torch.Tensor  # (C, F) per-eval-frame F1 on kept frames
    sizes: torch.Tensor      # (C,) encoded bytes
    host_pack: torch.Tensor  # (2, C) [f1; sizes], the one per-slot fetch
    flags: Optional[torch.Tensor] = None   # (len(SLOT_CHECKS),) if checked


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
    f1_frames = torch.where(st.tx[:, None], f1_frames, 0.0)
    sizes = torch.where(st.tx, st.sizes, 0.0)
    return FleetSlotOut(f1=f1, f1_frames=f1_frames, sizes=sizes,
                        host_pack=torch.stack([f1, sizes]))


def fleet_slot_step(cfg: CodecConfig, server_params: Params,
                    frames: torch.Tensor, masks: torch.Tensor,
                    b: torch.Tensor, r: torch.Tensor, keys: torch.Tensor,
                    keep: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_valid: torch.Tensor, live: torch.Tensor, *,
                    eval_frames: int, block_size: int, with_reuse: bool,
                    tables: CodecTables, conf_thresh: float = 0.4,
                    checked: bool = False) -> FleetSlotOut:
    """One slot of every method: ``_slot_encode`` then ``_slot_finish``.
    frames (C, N, H, W); masks (C, H/bs, W/bs) bool; b, r (C,); keys
    (C, 2); keep (C, N) bool (all True except for reducto); GT for all N
    frames; live (C,) bool.  ``with_reuse`` adds reducto's reuse arm;
    ``tables`` are the run's codec tables on the device; ``checked`` adds
    the ``SLOT_CHECKS`` flags."""
    st = _slot_encode(cfg, frames, masks, b, r, keys, keep, gt_boxes,
                      gt_valid, live, eval_frames=eval_frames,
                      block_size=block_size, with_reuse=with_reuse,
                      tables=tables)
    out = _slot_finish(server_params, st, conf_thresh=conf_thresh,
                       with_reuse=with_reuse)
    if not checked:
        return out
    f1, f1_frames, sizes = out.f1, out.f1_frames, out.sizes
    return out._replace(flags=_violated(
        torch.isfinite(f1).all() & torch.isfinite(sizes).all(),
        ((f1 >= -1e-3) & (f1 <= 1.0 + 1e-3)).all(),
        (sizes >= 0.0).all(),
        keep.any(dim=1).all(),
        torch.where(st.tx[:, None], True, f1_frames == 0.0).all()))


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
    flags: Optional[torch.Tensor] = None   # (len(CONTROL_CHECKS),) if checked


def fleet_control_step(mlp_params: Optional[Params], jcab_util, jcab_res,
                       lam, a, c, W_t: torch.Tensor, est: ElasticState,
                       tau_wl, tau_wh, live: torch.Tensor,
                       reconnect: torch.Tensor, *, method: str,
                       ecfg: ElasticConfig, bitrates: Tuple[int, ...],
                       resolutions: Tuple[float, ...], slot_seconds: float,
                       use_elastic: bool, w_cap: int, num_cams: int,
                       tables: CodecTables, checked: bool = False
                       ) -> ControlOut:
    """One slot of the server-side control loop: elastic adjustment ->
    utility table -> allocation, routed by method, left on the device.
    ``a``/``c`` are None for the content-agnostic methods; ``live`` (C,)
    and ``reconnect`` (0-d) are bool tensors.  The effective capacity floor
    is 0 (a hard-outage slot allocates nothing).  ``tables`` holds
    ``bitrates`` and ``resolutions`` on the device (``codec.device_tables``,
    built once per run).  ``checked`` adds the ``CONTROL_CHECKS`` flags."""
    dev = W_t.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    debt_ok = None          # checked only where the elastic update runs
    cap = W_t
    if method in ("deepstream", "deepstream_no_elastic"):
        area = torch.where(live, a, 0.0).sum()
        extra = zero
        if use_elastic:
            est, extra_kbits = elastic_mod.update(
                ecfg, est, area, W_t, tau_wl, tau_wh, reset_debt=reconnect)
            extra = extra_kbits / slot_seconds
        util, best_res = util_mod.utility_table(
            mlp_params, a, c, tables.bitrates, tables.resolutions, lam)
        W_eff = cap = torch.clamp(W_t + extra, min=0.0)
        _, b, r, _, feasible = alloc_mod.allocate_dp(
            util, best_res, bitrates, W_eff, w_cap=w_cap, live=live,
            rates=tables.bitrates)
        if checked and use_elastic:
            debt = est.debt_kbits
            debt_ok = (torch.isfinite(debt) & (debt >= -1e-3)
                       & (debt <= ecfg.budget_kbits + 1e-3))
    elif method == "jcab":
        area = extra = zero
        _, b, r, _, feasible = alloc_mod.allocate_dp(
            jcab_util, jcab_res, bitrates, W_t, w_cap=w_cap, live=live,
            rates=tables.bitrates)
    elif method in ("reducto", "static"):
        area = extra = zero
        b, feasible = alloc_mod.allocate_fair(tables.bitrates, W_t,
                                              num_cams, live=live)
        r = torch.ones((num_cams,), dtype=torch.float32, device=dev)
    else:
        raise ValueError(method)
    pack = torch.stack([extra, area, b.sum(), feasible.to(torch.float32)])
    flags = None
    if checked:
        if debt_ok is None:
            debt_ok = torch.ones((), dtype=torch.bool, device=dev)
        flags = _violated(
            debt_ok, live.any(), torch.isfinite(W_t) & (W_t >= 0.0),
            torch.isfinite(b).all() & torch.isfinite(pack).all(),
            torch.where(live, True, b == 0.0).all(),
            ~feasible | (b.sum() <= cap + 1.0))
    return ControlOut(b=b, r=r, est=est, pack=pack, flags=flags)


def fleet_control_scan(mlp_params: Optional[Params], jcab_util, jcab_res,
                       lam, a_trace: Optional[torch.Tensor],
                       c_trace: Optional[torch.Tensor], W_trace: torch.Tensor,
                       est: ElasticState, tau_wl, tau_wh,
                       live_trace: Optional[torch.Tensor] = None,
                       reconnect_trace: Optional[torch.Tensor] = None, *,
                       method: str, ecfg: ElasticConfig,
                       bitrates: Tuple[int, ...],
                       resolutions: Tuple[float, ...], slot_seconds: float,
                       use_elastic: bool, w_cap: int, num_cams: int,
                       tables: CodecTables
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  ElasticState]:
    """The whole control trajectory of a trace, the counterpart of the JAX
    package's ``lax.scan`` variant: (T, C) features and the (T,) bandwidth
    trace (``W_trace`` on the device) -> (T, C) b and r, (T, 4) log packs
    and the final elastic state.  A device loop of T ``fleet_control_step``
    calls that reads nothing back.  ``a_trace``/``c_trace`` may be None
    (zeros take their place); ``live_trace`` (T, C) and
    ``reconnect_trace`` (T,) default to all live and no reconnect."""
    dev = W_trace.device
    T = int(W_trace.shape[0])
    if live_trace is None:
        # audit: allow(host-sync) num_cams is a static int
        live_trace = torch.ones((T, int(num_cams)), dtype=torch.bool,
                                device=dev)
    if reconnect_trace is None:
        reconnect_trace = torch.zeros((T,), dtype=torch.bool, device=dev)
    if a_trace is None:
        # audit: allow(host-sync) num_cams is a static int
        a_trace = c_trace = torch.zeros((T, int(num_cams)),
                                        dtype=torch.float32, device=dev)
    deep = method in ("deepstream", "deepstream_no_elastic")
    bs, rs, packs = [], [], []
    for t in range(T):
        co = fleet_control_step(
            mlp_params, jcab_util, jcab_res, lam,
            a_trace[t] if deep else None, c_trace[t] if deep else None,
            W_trace[t], est, tau_wl, tau_wh, live_trace[t],
            reconnect_trace[t], method=method, ecfg=ecfg, bitrates=bitrates,
            resolutions=resolutions, slot_seconds=slot_seconds,
            use_elastic=use_elastic, w_cap=w_cap, num_cams=num_cams,
            tables=tables)
        est = co.est
        bs.append(co.b)
        rs.append(co.r)
        packs.append(co.pack)
    return torch.stack(bs), torch.stack(rs), torch.stack(packs), est


class EpisodeOut(NamedTuple):
    packs: torch.Tensor     # (T, 2, C) stacked [f1; sizes] per slot
    cpacks: torch.Tensor    # (T, 4) [extra, area, alloc_kbps, feasible],
                            # then the EPISODE_CHECKS flags if checked
    key: torch.Tensor       # the run key, unchanged (codec keys are a pure
                            # per-(slot, camera) fold, ``slot_camera_keys``)
    est: ElasticState       # final elastic state (last active slot's)
    ref: torch.Tensor       # (C, H, W) final reducto reference frames, the
                            # carry a windowed run hands to the next window


@dataclasses.dataclass(frozen=True)
class _Statics:
    """What a slot step's code depends on besides its tensors: the key of
    its CUDA graph (the JAX package's episode cache key, less the mesh)."""
    method: str
    scfg: SceneConfig
    ccfg: CodecConfig
    ecfg: ElasticConfig
    bitrates: Tuple[int, ...]
    resolutions: Tuple[float, ...]
    use_elastic: bool
    w_cap: int
    num_cams: int
    eval_frames: int
    block_size: int
    conf_thresh: float
    gt_pad: int
    pipelined: bool
    checked: bool


class _Ctx(NamedTuple):
    """Every tensor a slot step reads and no slot changes."""
    server: Params
    light: Params
    mlp: Params                  # {} for the content-agnostic methods
    jcab_util: torch.Tensor      # (C, J)
    jcab_res: torch.Tensor       # (C, J)
    lam: torch.Tensor            # (C,)
    scene: DeviceSceneParams
    key0: torch.Tensor
    skey: torch.Tensor
    tau_wl: torch.Tensor
    tau_wh: torch.Tensor
    tables: CodecTables
    t_first: torch.Tensor        # 0-d int64: the stream's first slot


class _Xs(NamedTuple):
    """The run's per-slot inputs, padded to the bucket."""
    t_idx: torch.Tensor          # (T_b,) int64 global slot indices
    trace: torch.Tensor          # (T_b,) f32 Kbps
    live: torch.Tensor           # (T_b, C) bool


class _Carry(NamedTuple):
    est: ElasticState
    ref: torch.Tensor            # (C, H, W) reducto reference frames
    live_prev: torch.Tensor      # (C,) bool previous slot's liveness


def slot_front(s: _Statics, ctx: _Ctx, carry: _Carry, t: torch.Tensor,
               W_t: torch.Tensor, live_t: torch.Tensor
               ) -> Tuple[_Carry, SlotStaged, torch.Tensor,
                          Optional[torch.Tensor]]:
    """Everything up to the staged detector batch for one slot: synthesis
    -> ROIDet -> control -> keep -> encode.  ``t`` (0-d int64), ``W_t``
    (0-d f32) and ``live_t`` (C,) bool are device tensors.  Returns (the
    advanced carry, the staged slot, the (4,) control pack, the inverse
    camera permutation or None).  A checked slot's control pack carries
    its flags after the 4 values: the trace check and ``CONTROL_CHECKS``
    (``_checked_row`` adds the F1 check at finish).  The pipelined body
    compacts the live cameras to the leading rows by a stable sort and
    zeroes the dead rows' frames; every stage after control is
    camera-row-local, so the live cameras' outputs are bitwise the
    reference body's, and ``inv`` puts the log columns back in camera
    order."""
    N, H, W = s.scfg.frames_per_segment, s.scfg.height, s.scfg.width
    dev = W_t.device
    deep = s.method in ("deepstream", "deepstream_no_elastic")
    frames, gtb, gtv = synth_mod.segments_device(
        s.scfg, ctx.scene, ctx.skey, t, gt_pad=s.gt_pad)
    keys = slot_camera_keys(ctx.key0, t, ctx.scene.cam_ids)
    reconnect = live_t & ~carry.live_prev
    a = c = None
    if deep:
        roi = roidet_mod.roidet_fleet(frames, ctx.light,
                                      block_size=s.block_size)
        masks, a, c = roi.mask, roi.area_ratio, roi.confidence
    else:
        masks = roidet_mod.full_frame_mask(s.num_cams, H, W, s.block_size,
                                           dev)
    co = fleet_control_step(
        ctx.mlp if deep else None, ctx.jcab_util, ctx.jcab_res, ctx.lam, a,
        c, W_t, carry.est, ctx.tau_wl, ctx.tau_wh, live_t, reconnect.any(),
        method=s.method, ecfg=s.ecfg, bitrates=s.bitrates,
        resolutions=s.resolutions, slot_seconds=s.ccfg.slot_seconds,
        use_elastic=s.use_elastic, w_cap=s.w_cap, num_cams=s.num_cams,
        tables=ctx.tables, checked=s.checked)
    cpack = co.pack
    if s.checked:
        cpack = torch.cat([cpack, _violated(torch.isfinite(W_t)), co.flags])
    ref = carry.ref
    if s.method == "reducto":
        # "first" is per run (t == t_first) and per reconnecting camera
        keep, ref = reducto_keep_step(
            frames, ref, reconnect | (t == ctx.t_first),
            block_size=s.block_size, edge_thresh=roidet_mod.EDGE_THRESH)
    else:
        keep = torch.ones((s.num_cams, N), dtype=torch.bool, device=dev)
    rows = (masks, co.b, co.r, keys, keep, gtb, gtv)
    live_e, inv = live_t, None
    if s.pipelined:
        order = torch.argsort((~live_t).to(torch.uint8), stable=True)
        inv = torch.argsort(order, stable=True)
        rows = tuple(x[order] for x in rows)
        live_e = live_t[order]
        frames = torch.where(live_e[:, None, None, None], frames[order], 0.0)
    st = _slot_encode(s.ccfg, frames, *rows, live_e,
                      eval_frames=s.eval_frames,
                      block_size=s.block_size,
                      with_reuse=s.method == "reducto", tables=ctx.tables)
    return _Carry(co.est, ref, live_t), st, cpack, inv


def _finish(s: _Statics, ctx: _Ctx, st: SlotStaged,
            inv: Optional[torch.Tensor]) -> torch.Tensor:
    """A staged slot's (2, C) [f1; sizes] log pack, in camera order."""
    pack = _slot_finish(ctx.server, st, conf_thresh=s.conf_thresh,
                        with_reuse=s.method == "reducto").host_pack
    return pack if inv is None else pack[:, inv]


def _checked_row(s: _Statics, cpack: torch.Tensor, pack: torch.Tensor
                 ) -> torch.Tensor:
    """A reference-body slot's control pack with, when checked, the
    episode's F1 check appended (the pack holds [f1; sizes])."""
    if not s.checked:
        return cpack
    return torch.cat([cpack, _violated(torch.isfinite(pack).all())])


def _episode_eager(s: _Statics, ctx: _Ctx, xs: _Xs, carry: _Carry, T: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, _Carry]:
    """The episode as a Python loop over the first T slots: the CPU's
    path, and on the card the comparison the graph is held to.  Returns
    ((T, 2, C) packs, (T, 4) control packs, the final carry)."""
    packs: List[torch.Tensor] = []
    cpacks: List[torch.Tensor] = []
    staged = None
    for i in range(T + s.pipelined):
        if s.pipelined and staged is not None:
            packs.append(_finish(s, ctx, *staged))   # slot i-1 (stage B)
            staged = None
        if i < T:
            carry, st, cpack, inv = slot_front(s, ctx, carry, xs.t_idx[i],
                                               xs.trace[i], xs.live[i])
            if s.pipelined:
                cpacks.append(cpack)
                staged = (st, inv)
            else:
                packs.append(_finish(s, ctx, st, inv))
                cpacks.append(_checked_row(s, cpack, packs[-1]))
    return torch.stack(packs), torch.stack(cpacks), carry


# -- the slot step as a CUDA graph ------------------------------------------

def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a nest of NamedTuples, tuples, dicts and None, in a
    fixed order."""
    if torch.is_tensor(x):
        return [x]
    if x is None:
        return []
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    return [y for v in x for y in _leaves(v)]


def _map(fn, x):
    """``x`` with ``fn`` applied to each of its tensors."""
    if torch.is_tensor(x):
        return fn(x)
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    items = [_map(fn, v) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def _copy(dst, src) -> None:
    """Copy every tensor of ``src`` into the same-shaped nest ``dst`` (on
    the current stream; a tensor copied onto itself is skipped)."""
    for d, v in zip(_leaves(dst), _leaves(src), strict=True):
        if d is not v:
            d.copy_(v)


_GRAPHS: Dict[tuple, "_EpisodeGraph"] = {}
_GRAPHS_LOCK = threading.Lock()
_CAPTURES = 0


def episode_graph_count() -> int:
    """CUDA graphs captured for episodes in this process (the counterpart
    of the JAX package's ``episode_compile_count``): a re-run of a
    configuration already seen adds zero."""
    return _CAPTURES


class _EpisodeGraph:
    """The slot step of one (statics, bucket, input shapes) on the card,
    captured as CUDA graphs that read and write static buffers: the run's
    inputs (copied in before each run, device to device), its per-slot rows
    (indexed on the device by a slot counter the graph advances), the
    carry, the stacked log packs and, for the pipelined body, the staged
    slot in two halves.  Pipelined graph ``full{p}`` runs stage B (finish
    the slot staged in half 1-p) on a second stream beside stage A (front
    the next slot into half p): two independent branches, forked and
    joined by events.  ``drain{p}`` is stage B alone, for the slot after
    the last.  The reference body is one graph, ``step``.  Row i of the
    packs holds slot i's logs (reference) or slot i-1's (pipelined, whose
    row 0 is the warm-up row and is dropped).  The host replays only the
    run's T slots and the drain: a padded slot never runs.  A replay goes
    through no kernel wrapper, so it adds nothing to their launch counts:
    the kernels a replay runs are counted on the card (CUPTI records)."""

    def __init__(self, s: _Statics, ctx: _Ctx, xs: _Xs, carry: _Carry):
        global _CAPTURES
        dev = xs.trace.device
        self.s = s
        self.ctx, self.xs, self.carry = (_map(torch.clone, v)
                                         for v in (ctx, xs, carry))
        self.counter = torch.zeros((), dtype=torch.int64, device=dev)
        rows = xs.trace.shape[0] + 1
        self.packs = torch.zeros((rows, 2, s.num_cams), device=dev)
        self.cpacks = torch.zeros(
            (rows, 4 + (len(EPISODE_CHECKS) if s.checked else 0)),
            device=dev)
        self.side = torch.cuda.Stream(dev)
        self.halves = None
        # build the kernels, bind their entry points, let cuDNN and cuBLAS
        # set up, and learn the staged slot's shapes: eagerly, on a side
        # stream, before anything is captured
        warm = torch.cuda.Stream(dev)
        warm.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(warm):
            if s.pipelined:
                _, st, _, inv = slot_front(s, self.ctx, self.carry,
                                           *self._slot_inputs())
                self.halves = [_map(torch.zeros_like, (st, inv))
                               for _ in range(2)]
            bodies = self._bodies()
            for body in bodies.values():
                self.counter.zero_()
                body()
        torch.cuda.current_stream(dev).wait_stream(warm)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        pool = None
        for name, body in bodies.items():
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                body()
            pool = g.pool()
            self.graphs[name] = g
            _CAPTURES += 1

    def _slot_inputs(self):
        """(t, W_t, live_t) of the slot the counter points at."""
        i = self.counter.view(1)
        return tuple(x.index_select(0, i)[0] for x in self.xs)

    def _bodies(self):
        if not self.s.pipelined:
            return {"step": self._step}
        return {f"{kind}{p}": (lambda f=fn, q=p: f(q))
                for kind, fn in (("full", self._full), ("drain", self._drain))
                for p in (0, 1)}

    def _finish_into(self, half) -> torch.Tensor:
        pack = _finish(self.s, self.ctx, *half)
        self.packs.index_copy_(0, self.counter.view(1), pack[None])
        return pack

    def _front(self):
        """Slot front into the carry; returns ((staged, inv), cpack)."""
        carry, st, cpack, inv = slot_front(self.s, self.ctx, self.carry,
                                           *self._slot_inputs())
        _copy(self.carry, carry)
        return (st, inv), cpack

    def _put_cpack(self, cpack: torch.Tensor) -> None:
        self.cpacks.index_copy_(0, self.counter.view(1), cpack[None])

    def _step(self) -> None:
        staged, cpack = self._front()
        pack = self._finish_into(staged)
        self._put_cpack(_checked_row(self.s, cpack, pack))
        self.counter.add_(1)

    def _full(self, p: int) -> None:
        main = torch.cuda.current_stream()
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            self._finish_into(self.halves[1 - p])      # stage B: slot i-1
        staged, cpack = self._front()                  # stage A: slot i
        self._put_cpack(cpack)
        _copy(self.halves[p], staged)
        main.wait_stream(self.side)
        self.counter.add_(1)

    def _drain(self, p: int) -> None:
        self._finish_into(self.halves[1 - p])

    def run(self, ctx: _Ctx, xs: _Xs, carry: _Carry, T: int
            ) -> Tuple[torch.Tensor, torch.Tensor, _Carry]:
        """Load the run's inputs and replay the first T slots; the same
        return as ``_episode_eager``, copied out of the static buffers."""
        _copy(self.ctx, ctx)
        _copy(self.xs, xs)
        _copy(self.carry, carry)
        self.counter.zero_()
        if self.s.pipelined:
            for i in range(T):
                self.graphs[f"full{i % 2}"].replay()
            self.graphs[f"drain{T % 2}"].replay()
            packs = self.packs[1:T + 1]
        else:
            for _ in range(T):
                self.graphs["step"].replay()
            packs = self.packs[:T]
        return (packs.clone(), self.cpacks[:T].clone(),
                _map(torch.clone, self.carry))


def _episode_graphed(s: _Statics, ctx: _Ctx, xs: _Xs, carry: _Carry,
                     T: int) -> Tuple[torch.Tensor, torch.Tensor, _Carry]:
    """The episode on the card: the graphs of (statics, bucket, input
    shapes), captured on first use, replayed for the T active slots.  One
    run at a time uses a graph's static buffers (callers share the current
    stream)."""
    key = (s, xs.trace.device) + tuple(
        (tuple(x.shape), x.dtype) for x in _leaves((ctx, xs, carry)))
    with _GRAPHS_LOCK:
        graph = _GRAPHS.get(key)
        if graph is None:
            graph = _GRAPHS[key] = _EpisodeGraph(s, ctx, xs, carry)
        return graph.run(ctx, xs, carry, T)


class EpisodeInputs(NamedTuple):
    """``episode_inputs``' result."""
    statics: _Statics
    ctx: _Ctx
    xs: _Xs
    carry: _Carry
    T: int


def episode_inputs(method: str, *, codec_cfg: CodecConfig,
                   scene_cfg: SceneConfig, server_params: Params,
                   light_params: Params, mlp_params: Optional[Params],
                   jcab_util, jcab_res, lam: torch.Tensor,
                   scene_params: DeviceSceneParams, trace: torch.Tensor,
                   key0: torch.Tensor, skey: torch.Tensor, tau_wl, tau_wh,
                   est0: ElasticState, ecfg: ElasticConfig,
                   bitrates: Sequence[int], resolutions: Sequence[float],
                   use_elastic: bool, w_cap: int, num_cams: int,
                   eval_frames: int, block_size: int,
                   conf_thresh: float = 0.4, gt_pad: int = 16,
                   t_start: int = 0,
                   buckets: Optional[Sequence[int]] = EPISODE_BUCKETS,
                   faults: Optional[np.ndarray] = None,
                   ref0: Optional[torch.Tensor] = None,
                   live_prev0: Optional[np.ndarray] = None,
                   t_first: Optional[int] = None, pipelined: bool = True,
                   checked: bool = False) -> EpisodeInputs:
    """What ``fleet_episode`` runs, before it runs: the statics (the
    graph key's), the context, the run's per-slot inputs padded to the
    bucket, the carry and T.  ``analysis.programs`` builds its registry
    from it, so the registry describes the graphs the episode captures."""
    N, H, W = (scene_cfg.frames_per_segment, scene_cfg.height,
               scene_cfg.width)
    dev = trace.device
    T = int(trace.shape[0])
    T_b = bucket_len(T, buckets)
    live_np = np.ones((T_b, num_cams), bool)
    if faults is not None:
        faults = np.asarray(faults, bool)
        if faults.shape != (T, num_cams):
            raise ValueError(f"faults mask must be (T={T}, C={num_cams}) "
                             f"bool, got {faults.shape}")
        if not faults.any(axis=1).all():
            raise ValueError("faults mask leaves a slot with zero live "
                             "cameras — the control step needs >= 1")
        live_np[:T] = faults
    xs = _Xs(
        t_idx=torch.arange(T_b, dtype=torch.int64, device=dev) + t_start,
        trace=torch.cat([trace.to(torch.float32),
                         trace.new_zeros(T_b - T, dtype=torch.float32)]),
        live=upload(live_np, dev))
    carry = _Carry(
        est=est0,
        ref=(torch.zeros((num_cams, H, W), dtype=torch.float32, device=dev)
             if ref0 is None else ref0.to(dev, torch.float32)),
        live_prev=(torch.ones((num_cams,), dtype=torch.bool, device=dev)
                   if live_prev0 is None else upload(live_prev0, dev, bool)))
    J = len(bitrates)
    if jcab_util is None:
        jcab_util = torch.zeros((num_cams, J), dtype=torch.float32,
                                device=dev)
        jcab_res = torch.ones((num_cams, J), dtype=torch.float32, device=dev)
    ctx = _Ctx(
        server=server_params, light=light_params, mlp=mlp_params or {},
        jcab_util=jcab_util, jcab_res=jcab_res, lam=lam, scene=scene_params,
        key0=key0, skey=skey, tau_wl=tau_wl, tau_wh=tau_wh,
        tables=codec_mod.device_tables(bitrates, resolutions, dev),
        t_first=torch.full((), t_start if t_first is None else t_first,
                           dtype=torch.int64, device=dev))
    # the generator reads only the shape-like fields of the scene config:
    # its seed lives in the device params
    s = _Statics(
        method=method, scfg=dataclasses.replace(scene_cfg, seed=0),
        ccfg=codec_cfg, ecfg=ecfg, bitrates=tuple(int(b) for b in bitrates),
        resolutions=tuple(float(r) for r in resolutions),
        use_elastic=bool(use_elastic), w_cap=int(w_cap),
        num_cams=int(num_cams), eval_frames=int(eval_frames),
        block_size=int(block_size), conf_thresh=float(conf_thresh),
        gt_pad=int(gt_pad), pipelined=bool(pipelined) and not checked,
        checked=bool(checked))
    return EpisodeInputs(s, ctx, xs, carry, T)


def fleet_episode(method: str, *, _eager: bool = False, **kw
                  ) -> EpisodeOut:
    """Run a whole bandwidth trace (``trace`` (T,) f32 on the device) and
    return the stacked logs and the final carry, still on the device.
    ``kw`` are ``episode_inputs``' keyword arguments.

    ``pipelined=True`` (the default, the production body) overlaps slot
    i's front with slot i-1's finish and compacts each slot's live
    cameras; ``pipelined=False`` is the reference body it equals bitwise.
    ``checked=True`` (the diagnostics lane) runs the reference body and
    returns each slot's ``EPISODE_CHECKS`` flags after its 4 control-pack
    values in ``cpacks``; the caller raises after the harvest.
    ``faults`` is the optional (T, C) bool liveness mask (True = live).
    T is padded to ``bucket_len(T, buckets)`` for the per-slot buffers
    (``buckets=None``: no padding); padded slots never run (see
    ``bucket_len``), and the logs come back sliced to T.  ``w_cap`` must
    come from the active trace.

    Streaming carry: ``est0``, ``ref0`` ((C, H, W) reducto reference),
    ``live_prev0`` ((C,) bool previous liveness row) and ``t_first`` (the
    stream's first slot, distinct from this window's ``t_start``) seed the
    episode from the previous window, so a chain of windows is slot for
    slot one long episode; the defaults are a standalone run's (zeros,
    all live, ``t_start``).

    On a CUDA device the slot step runs as CUDA graphs (``_EpisodeGraph``)
    and no slot reads the device from the host; on the CPU it runs
    eagerly.  ``_eager`` runs the eager loop on the card too, for
    comparison only."""
    inp = episode_inputs(method, **kw)
    run = (_episode_graphed if inp.xs.trace.device.type == "cuda"
           and not _eager else _episode_eager)
    packs, cpacks, carry = run(inp.statics, inp.ctx, inp.xs, inp.carry,
                               inp.T)
    return EpisodeOut(packs=packs, cpacks=cpacks, key=inp.ctx.key0,
                      est=carry.est, ref=carry.ref)


def eval_indices(n: int, eval_frames: int) -> np.ndarray:
    """The sequential runner's scored-frame selection: min(F, n) evenly
    spaced frames of n."""
    return np.linspace(0, n - 1, min(eval_frames, n)).astype(int)


def gt_capacity(max_boxes_per_frame: int, min_boxes: int = 16) -> int:
    """Fixed GT padding G for a scene: the smallest multiple of 8 >=
    max(min_boxes, max_boxes_per_frame)."""
    return max(min_boxes, -(-max_boxes_per_frame // 8) * 8)


def pad_gt(gts: Sequence[Sequence[Sequence[Tuple]]], idx: np.ndarray,
           G: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged host GT lists -> padded arrays: gts[cam][frame] lists of
    (x0, y0, x1, y1), idx (C, F) frame indices -> (boxes (C, F, G, 4)
    float32, valid (C, F, G) bool).  G is the scene's fixed capacity
    (``gt_capacity``); a frame with more boxes is an error, never a
    larger G."""
    C, F = idx.shape
    boxes = np.zeros((C, F, G, 4), np.float32)
    valid = np.zeros((C, F, G), bool)
    for c_i in range(C):
        for f_i in range(F):
            bxs = gts[c_i][int(idx[c_i, f_i])]
            assert len(bxs) <= G, (
                f"slot has {len(bxs)} GT boxes > scene capacity G={G}; raise "
                "SceneConfig.max_objects-derived gt_capacity instead")
            for g_i, bx in enumerate(bxs):
                boxes[c_i, f_i, g_i] = bx
                valid[c_i, f_i, g_i] = True
    return boxes, valid


def pad_gt_all(gts: Sequence[Sequence[Sequence[Tuple]]], num_frames: int,
               G: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """``pad_gt`` over every frame of the slot: (C, N, G, 4), (C, N, G)."""
    idx = np.tile(np.arange(num_frames), (len(gts), 1))
    return pad_gt(gts, idx, G=G)
