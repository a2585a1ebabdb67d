"""Content-aware multi-camera bandwidth allocation (paper section 5.2).

The counterparts of ``repro.core.allocation``'s allocators, in two forms:

  * device (``allocate_dp`` = ``allocate_dp_jax``, ``allocate_fair`` =
    ``allocate_fair_jax``, ``allocate_greedy`` = ``allocate_greedy_jax``):
    tensors in and out, the knapsack DP at one static capacity with the
    capacity and liveness as tensors, so the control step never waits on
    the host;
  * host (``allocate_dp_host`` = ``allocate_dp``, ``allocate_fair_host`` =
    ``allocate_fair``, ``allocate_greedy_host`` = ``allocate_greedy``):
    numpy in, ``Allocation`` out, the capacity a Python float.  The DP
    sweeps on a device (``dp_ops.solve``) and backtracks in numpy.

Dead cameras are forced onto the cheapest option at zero utility and the
capacity grows by what those forced picks cost, so live cameras solve the
DP a dead-row-free table would; they then receive 0 Kbps.  W <= 0 is the
all-zero infeasible allocation.  The host grid index floors W/d in
float64, the device one in float32, as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import reduce
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import utility as util_mod
from repro_torch.kernels.knapsack_dp import ops as dp_ops


@dataclass
class Allocation:
    bitrates_kbps: np.ndarray   # (I,)
    resolutions: np.ndarray     # (I,)
    predicted_utility: float
    feasible: bool


def _grid(bitrates: Sequence[int]) -> Tuple[np.ndarray, int]:
    """(integer bitrates, d = gcd) — the DP's cost grid."""
    bitr = np.asarray(bitrates, np.int64)
    return bitr, reduce(math.gcd, [int(b) for b in bitr])


def dp_capacity(bitrates: Sequence[int], W_max_kbps: float) -> int:
    """Static bucketed DP capacity (grid units) covering W <= W_max_kbps."""
    _, d = _grid(bitrates)
    return dp_ops.bucket_capacity(int(float(W_max_kbps) // d))


def trace_capacity(bitrates: Sequence[int], trace_kbps, num_cams: int, *,
                   elastic_borrow_kbps: float = 0.0,
                   pin_kbps: Optional[float] = None) -> int:
    """``dp_capacity`` for a whole trace: its max plus the elastic borrow,
    at least the all-minimum clamp, optionally pinned, plus min-bitrate
    headroom per camera for the dead-camera forced rows."""
    W_max = float(np.max(np.asarray(trace_kbps))) + float(elastic_borrow_kbps)
    W_max = max(W_max, float(min(int(b) for b in bitrates)) * int(num_cams))
    if pin_kbps is not None:
        if W_max > float(pin_kbps):
            raise ValueError(
                f"w_cap pin {pin_kbps} Kbps does not cover this trace "
                f"(needs >= {W_max} Kbps incl. elastic borrow + clamp)")
        W_max = float(pin_kbps)
    W_max += float(min(int(b) for b in bitrates)) * int(num_cams)
    return dp_capacity(bitrates, W_max)


def build_utility_table(mlp_params, a: np.ndarray, c: np.ndarray,
                        bitrates: Sequence[int], resolutions: Sequence[float],
                        weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The host allocator's (util (I, J), best_res (I, J)): the device
    ``utility.utility_table`` on the MLP's device, fetched, so both
    control paths build bitwise the same table."""
    dev = next(iter(mlp_params.values())).device
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
    util, best_res = util_mod.utility_table(
        mlp_params, f32(a), f32(c), f32(bitrates), f32(resolutions),
        f32(weights))
    return util.cpu().numpy(), best_res.cpu().numpy()


def allocate_dp_host(util: np.ndarray, best_res: np.ndarray,
                     bitrates: Sequence[int], W_kbps: float,
                     live: Optional[np.ndarray] = None, *,
                     device=None) -> Allocation:
    """Host knapsack allocation at capacity ``W_kbps`` (a float): W <= 0
    sends nothing; a capacity below every live camera's minimum clamps
    them to it (infeasible); else the DP on ``device``."""
    bitr, d = _grid(bitrates)
    costs = (bitr // d).astype(np.int32)
    Wg = int(W_kbps // d)
    I = util.shape[0]
    live = np.ones(I, bool) if live is None else np.asarray(live, bool)
    n_live = int(live.sum())
    n_dead = I - n_live
    jmin = int(np.argmin(costs))
    cmin = int(costs[jmin])
    iidx = np.arange(I)
    if W_kbps <= 0.0:
        return Allocation(np.zeros(I, np.float64), np.ones(I, np.float64),
                          0.0, feasible=False)
    if cmin * n_live > Wg:
        return Allocation(np.where(live, float(bitr[jmin]), 0.0),
                          np.where(live, best_res[:, jmin], 1.0)
                          .astype(np.float64),
                          float(util[live, jmin].sum()), feasible=False)
    util_eff = np.where(live[:, None], util,
                        np.where(np.arange(util.shape[1])[None, :] == jmin,
                                 0.0, -1e9))
    picks, total = dp_ops.solve(util_eff.astype(util.dtype), costs,
                                Wg + n_dead * cmin, device=device)
    return Allocation(np.where(live, bitr[picks].astype(np.float64), 0.0),
                      np.where(live, best_res[iidx, picks], 1.0)
                      .astype(np.float64),
                      float(total), feasible=True)


def allocate_fair_host(bitrates: Sequence[int], W_kbps: float,
                       num_cams: int,
                       live: Optional[np.ndarray] = None) -> Allocation:
    """Host equal share among live cameras: the largest bitrate <= W /
    n_live, else the minimum (infeasible); W <= 0 sends nothing."""
    live = np.ones(num_cams, bool) if live is None else np.asarray(live, bool)
    if W_kbps <= 0:
        return Allocation(np.zeros(num_cams), np.ones(num_cams), 0.0,
                          feasible=False)
    share = W_kbps / max(int(live.sum()), 1)
    bitr = np.asarray(bitrates, np.float64)
    feas = bitr[bitr <= share]
    feasible = len(feas) > 0
    b = feas.max() if feasible else bitr.min()
    return Allocation(np.where(live, b, 0.0), np.ones(num_cams), 0.0,
                      feasible=feasible)


def allocate_greedy_host(util: np.ndarray, best_res: np.ndarray,
                         bitrates: Sequence[int], W_kbps: float,
                         live: Optional[np.ndarray] = None) -> Allocation:
    """Greedy upgrades by marginal utility per Kbps (the continuous
    heuristic), in float64.  Zero-gain upgrades are taken (positive gains
    still win): on a utility plateau, refusing the free step would strand
    budget below later positive-gain upgrades."""
    bitr = np.asarray(bitrates, np.float64)
    I, J = util.shape
    live = np.ones(I, bool) if live is None else np.asarray(live, bool)
    iidx = np.arange(I)
    if W_kbps <= 0:
        return Allocation(np.zeros(I), np.ones(I), 0.0, feasible=False)
    picks = np.zeros(I, np.int64)
    budget = W_kbps - bitr[0] * int(live.sum())
    if budget < 0:
        return Allocation(np.where(live, bitr[0], 0.0),
                          np.where(live, best_res[:, 0], 1.0),
                          float(util[live, 0].sum()), feasible=False)
    while True:
        best_gain, best_i = -1.0, -1
        for i in range(I):
            j = picks[i]
            if live[i] and j + 1 < J:
                dc = bitr[j + 1] - bitr[j]
                gain = (util[i, j + 1] - util[i, j]) / max(dc, 1e-9)
                if dc <= budget and gain >= 0.0 and gain > best_gain:
                    best_gain, best_i = gain, i
        if best_i < 0:
            break
        j = picks[best_i]
        budget -= bitr[j + 1] - bitr[j]
        picks[best_i] = j + 1
    return Allocation(np.where(live, bitr[picks], 0.0),
                      np.where(live, best_res[iidx, picks], 1.0),
                      float(util[iidx, picks][live].sum()), feasible=True)


def allocate_greedy(util: torch.Tensor, best_res: torch.Tensor,
                    bitrates: Sequence[int], W_kbps: torch.Tensor,
                    live: Optional[torch.Tensor] = None):
    """Device greedy (the JAX package's fallback when the DP kernel is
    off): util/best_res (I, J), W_kbps 0-d -> (picks, b, res, total,
    feasible).  The JAX ``while_loop`` becomes a fixed I * (J - 1) rounds,
    the most upgrades there can be; a round takes the best upgrade (first
    camera on ties) only while every round before it found one, so the
    picks are the loop's and nothing is read back."""
    dev = util.device
    bitr = torch.as_tensor(bitrates, dtype=torch.float32, device=dev)
    I, J = util.shape
    iidx = torch.arange(I, device=dev)
    live = (torch.ones((I,), dtype=torch.bool, device=dev) if live is None
            else live)
    W = W_kbps.to(torch.float32)
    open_ = W > 0.0
    budget = W - bitr[0] * live.to(torch.float32).sum()
    feasible = (budget >= 0) & open_
    picks = torch.zeros((I,), dtype=torch.int64, device=dev)
    active = feasible
    for _ in range(I * (J - 1)):
        can = (picks + 1 < J) & live
        jn = torch.where(can, picks + 1, picks)
        dc = bitr[jn] - bitr[picks]
        gain = (util[iidx, jn] - util[iidx, picks]) / torch.clamp(dc,
                                                                  min=1e-9)
        ok = can & (dc <= budget) & (gain >= 0.0)
        best_i = torch.argmax(torch.where(ok, gain, -math.inf))
        active = active & ok.any()
        picks = picks.index_add(0, best_i[None], active.to(torch.int64)[None])
        budget = budget - torch.where(active, dc[best_i], 0.0)
    tx = live & open_
    b = torch.where(tx, bitr[picks], 0.0)
    res = torch.where(tx, best_res[iidx, picks], 1.0)
    total = (torch.where(live, util[iidx, picks], 0.0).sum()
             * open_.to(util.dtype))
    return picks, b, res, total, feasible


def allocate_dp(util: torch.Tensor, best_res: torch.Tensor,
                bitrates: Sequence[int], W_kbps: torch.Tensor, *, w_cap: int,
                rates: torch.Tensor,
                live: Optional[torch.Tensor] = None):
    """util/best_res (I, J), W_kbps 0-d f32 -> (picks (I,), b (I,),
    res (I,), total, feasible), all on device.  The grid index floors
    W/d in float32, as the JAX package does.  ``rates`` is ``bitrates`` as
    a (J,) f32 tensor on the device (``CodecTables.bitrates``, built once
    per run), so that the grid's constants are not uploaded per slot."""
    bitr, d = _grid(bitrates)
    costs_np = (bitr // d).astype(np.int64)
    I, J = util.shape
    dev = util.device
    jmin = int(np.argmin(costs_np))
    cmin = int(costs_np[jmin])
    if cmin * I > w_cap:
        raise ValueError(f"w_cap={w_cap} cannot express the all-minimum "
                         f"clamp for {I} cameras")
    # d divides every bitrate, so the float32 quotient is the exact cost
    costs = (rates / d).to(torch.int32)
    W = W_kbps.to(torch.float32)
    open_ = W > 0.0
    live = (torch.ones((I,), dtype=torch.bool, device=dev) if live is None
            else live)
    n_live = live.to(torch.int32).sum()
    forced = torch.where(torch.arange(J, device=dev) == jmin, 0.0, -1e9)
    util_eff = torch.where(live[:, None], util, forced[None, :])
    Wg = torch.clamp(torch.floor(W / d).to(torch.int32), max=w_cap)
    feasible = (cmin * n_live <= Wg) & open_
    Wg_eff = torch.clamp(Wg + (I - n_live) * cmin, max=w_cap)
    picks, total = dp_ops.solve_device(
        util_eff, costs, torch.clamp(Wg_eff, min=cmin * I), w_cap=w_cap)
    tx = live & open_
    b = torch.where(tx, rates[picks], 0.0)
    res = torch.where(tx, best_res[torch.arange(I, device=dev), picks], 1.0)
    return picks, b, res, total * open_.to(total.dtype), feasible


def allocate_fair(bitrates: Sequence[int], W_kbps: torch.Tensor,
                  num_cams: int, live: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equal share among live cameras: the largest bitrate <= W / n_live,
    else the minimum (infeasible).  Returns ((I,) bitrates, feasible).
    ``bitrates`` is a sequence or, on the slot step, the (J,) f32 device
    table ``CodecTables.bitrates``."""
    dev = W_kbps.device
    bitr = torch.as_tensor(bitrates, dtype=torch.float32, device=dev)
    live = (torch.ones((num_cams,), dtype=torch.bool, device=dev)
            if live is None else live)
    W = W_kbps.to(torch.float32)
    open_ = W > 0.0
    share = W / torch.clamp(live.to(torch.float32).sum(), min=1.0)
    ok = bitr <= share
    feasible = torch.any(ok)
    b = torch.where(feasible, torch.where(ok, bitr, -math.inf).max(),
                    bitr.min())
    return torch.where(live & open_, b, 0.0), feasible & open_
