"""Plain multiple-choice knapsack DP (paper section 5.2) and its backtrack.

V_0[w] = 0;  V_i[w] = max_j V_{i-1}[w - cost_j] + u[i, j]  (w >= cost_j),
ties to the lowest j.  The episode's control step uses this plain sweep;
the hand-written kernel (``repro.kernels.knapsack_dp.knapsack_dp_pallas``
on the TPU) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e30


def knapsack_dp_ref(util: torch.Tensor, costs: torch.Tensor, W: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """util (I, J) f32; costs (J,) int grid units; W grid capacity ->
    (values (W+1,), choices (I, W+1) int32)."""
    I, J = util.shape
    dev = util.device
    src = (torch.arange(W + 1, device=dev)[:, None]
           - costs.to(torch.int64)[None])
    valid = src >= 0
    src = torch.clamp(src, min=0)
    v = torch.zeros((W + 1,), dtype=torch.float32, device=dev)
    choices = []
    for i in range(I):
        cand = torch.where(valid, v[src] + util[i][None, :], NEG)
        j = torch.argmax(cand, dim=1)
        v = torch.gather(cand, 1, j[:, None])[:, 0]
        choices.append(j.to(torch.int32))
    return v, torch.stack(choices)


def backtrack(choices: torch.Tensor, costs: torch.Tensor,
              values: torch.Tensor, Wg: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best w <= Wg (a 0-d tensor, first on ties), then the reverse cost
    walk, on device with gathers (no host round trip).  Returns (picks
    (I,) int64, achieved total)."""
    I = choices.shape[0]
    w_idx = torch.arange(values.shape[0], device=values.device)
    masked = torch.where(w_idx <= Wg, values, NEG)
    total = masked.max()
    w = torch.argmax(masked).reshape(1)
    costs = costs.to(torch.int64)
    picks = []
    for i in range(I - 1, -1, -1):
        j = choices[i].gather(0, w).to(torch.int64)
        picks.append(j)
        w = torch.clamp(w - costs.gather(0, j), min=0)
    return torch.cat(picks[::-1]), total
