"""Elastic Transmission Mechanism (paper section 5.3).

The area threshold tau_a = EMA + gamma_a * sigma of the total ROI area,
time borrowing when the area is high and the link low (bounded by
``budget_kbits``), repayment when the link is high, and the EMA/variance
update.  Two forms, as in ``repro.core.elastic``:

  * ``update`` (= ``update_jax``): the state is four 0-d float32 tensors,
    so the device control step never syncs with the host; ``update_scan``
    runs it over a whole trace;
  * ``update_host`` (= ``update``): Python floats (float64) threaded as a
    ``HostElasticState``, for the host control path.

``offline_thresholds`` derives (tau_wl, tau_wh) from the profiled
accuracy table (numpy, copied from the JAX package).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import prng


@dataclass(frozen=True)
class ElasticConfig:
    alpha: float = 0.15          # EMA factor on total ROI area
    gamma_a: float = 0.5         # aggressiveness on the area threshold
    gamma_wl: float = 0.6        # aggressiveness of time borrowing
    sigma_high: float = 0.05     # offline accuracy-delta std gates
    sigma_low: float = 0.01
    budget_kbits: float = 1500.0 # max outstanding borrowed data (Kbit)
    slot_seconds: float = 1.0


@dataclass(frozen=True)
class HostElasticState:
    a_ema: float = 0.0
    a_var: float = 0.0
    debt_kbits: float = 0.0      # outstanding borrowed data
    initialized: bool = False


def offline_thresholds(cfg: ElasticConfig, acc_table: np.ndarray,
                       bitrates: np.ndarray) -> Tuple[float, float]:
    """acc_table (segments, I, J) profiled accuracy per camera and bitrate
    -> (tau_wl, tau_wh) in Kbps (paper section 5.3.1b): the std over
    segments of each bitrate's accuracy gap to the highest bitrate,
    averaged over cameras; tau_wl is I times the highest bitrate whose std
    exceeds ``sigma_high`` (else the lowest), tau_wh I times the lowest
    whose std is under ``sigma_low`` (else the highest)."""
    n_seg, I, J = acc_table.shape
    deltas = acc_table - acc_table[:, :, -1:]
    stds = deltas.std(axis=0).mean(axis=0)      # (J,)
    need_more = [j for j in range(J) if stds[j] > cfg.sigma_high]
    can_give = [j for j in range(J) if stds[j] < cfg.sigma_low]
    tau_wl = (float(bitrates[max(need_more)] * I) if need_more
              else float(bitrates[0] * I))
    tau_wh = (float(bitrates[min(can_give)] * I) if can_give
              else float(bitrates[-1] * I))
    return tau_wl, tau_wh


def update_host(cfg: ElasticConfig, state: HostElasticState,
                total_area: float, W_kbps: float, tau_wl: float,
                tau_wh: float, reset_debt: bool = False
                ) -> Tuple[HostElasticState, float, dict]:
    """One slot in float64.  Returns (new state, extra capacity in Kbit,
    log); ``reset_debt`` clears the debt before the slot (a camera
    rejoined).  The first slot only seeds the EMA."""
    if not state.initialized:
        st = HostElasticState(a_ema=total_area, a_var=0.0, debt_kbits=0.0,
                              initialized=True)
        return st, 0.0, {"tau_a": math.inf, "borrowed": 0.0, "repaid": 0.0}
    sigma_a = math.sqrt(max(state.a_var, 1e-12))
    tau_a = state.a_ema + cfg.gamma_a * sigma_a
    borrowed = repaid = 0.0
    debt = 0.0 if reset_debt else state.debt_kbits
    if total_area > tau_a and W_kbps < tau_wl:
        headroom = cfg.budget_kbits - debt
        borrowed = min(cfg.gamma_wl * (tau_wl - W_kbps) * cfg.slot_seconds,
                       max(headroom, 0.0))
        debt += borrowed
    elif W_kbps >= tau_wh and debt > 0.0:
        repaid = min(debt, (W_kbps - tau_wh) * cfg.slot_seconds)
        debt -= repaid
    delta = total_area - state.a_ema
    a_ema = state.a_ema + cfg.alpha * delta
    a_var = (1 - cfg.alpha) * (state.a_var + cfg.alpha * delta * delta)
    new_state = HostElasticState(a_ema=a_ema, a_var=a_var, debt_kbits=debt,
                                 initialized=True)
    return new_state, borrowed - repaid, {
        "tau_a": tau_a, "borrowed": borrowed, "repaid": repaid, "debt": debt}


class ElasticState(NamedTuple):
    a_ema: torch.Tensor
    a_var: torch.Tensor
    debt_kbits: torch.Tensor
    initialized: torch.Tensor    # bool; selects the first-slot branch


def init_state(device) -> ElasticState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return ElasticState(a_ema=z, a_var=z, debt_kbits=z,
                        initialized=torch.zeros((), dtype=torch.bool,
                                                device=device))


def update(cfg: ElasticConfig, state: ElasticState, total_area: torch.Tensor,
           W_kbps: torch.Tensor, tau_wl: torch.Tensor, tau_wh: torch.Tensor,
           reset_debt: Optional[torch.Tensor] = None
           ) -> Tuple[ElasticState, torch.Tensor]:
    """One slot; returns (new state, extra capacity in Kbit).  Both
    branches are computed and selected, as in the traced JAX update."""
    debt0 = state.debt_kbits
    if reset_debt is not None:
        debt0 = torch.where(reset_debt, 0.0, debt0)
    sigma_a = prng.sqrt(torch.clamp(state.a_var, min=1e-12))
    tau_a = state.a_ema + cfg.gamma_a * sigma_a
    borrow = (total_area > tau_a) & (W_kbps < tau_wl)
    headroom = torch.clamp(cfg.budget_kbits - debt0, min=0.0)
    borrowed = torch.where(
        borrow, torch.minimum(cfg.gamma_wl * (tau_wl - W_kbps)
                              * cfg.slot_seconds, headroom), 0.0)
    repay = ~borrow & (W_kbps >= tau_wh) & (debt0 > 0.0)
    repaid = torch.where(
        repay, torch.minimum(debt0, (W_kbps - tau_wh) * cfg.slot_seconds),
        0.0)
    debt = debt0 + borrowed - repaid
    delta = total_area - state.a_ema
    a_ema = state.a_ema + cfg.alpha * delta
    a_var = (1 - cfg.alpha) * (state.a_var + cfg.alpha * delta * delta)
    init = state.initialized
    new_state = ElasticState(
        a_ema=torch.where(init, a_ema, total_area),
        a_var=torch.where(init, a_var, 0.0),
        debt_kbits=torch.where(init, debt, 0.0),
        initialized=torch.ones_like(init))
    extra = torch.where(init, borrowed, 0.0) - torch.where(init, repaid, 0.0)
    return new_state, extra


def update_scan(cfg: ElasticConfig, state: ElasticState, areas: torch.Tensor,
                Ws: torch.Tensor, tau_wl: torch.Tensor, tau_wh: torch.Tensor
                ) -> Tuple[ElasticState, torch.Tensor]:
    """``update`` over a whole trace, a device loop that reads nothing
    back: areas and Ws (T,) f32 -> (final state, per-slot extra capacity
    (T,) in Kbit)."""
    extras = []
    for t in range(int(areas.shape[0])):
        state, extra = update(cfg, state, areas[t], Ws[t], tau_wl, tau_wh)
        extras.append(extra)
    out = (torch.stack(extras) if extras else
           torch.zeros((0,), dtype=torch.float32, device=areas.device))
    return state, out
