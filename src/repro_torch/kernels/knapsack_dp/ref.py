"""Plain multiple-choice knapsack DP (paper section 5.2) and its backtracks.

V_0[w] = 0;  V_i[w] = max_j V_{i-1}[w - cost_j] + u[i, j]  (w >= cost_j),
ties to the lowest j.  ``knapsack_dp_ref`` is the plain PyTorch version of
the hand-written sweep (``csrc/knapsack_dp.cu``), and ``knapsack_dp_ref``
followed by ``backtrack_device`` (gathers on the tensors' device) that of
the kernel's solve: CPU tensors take them, and the card compares the
kernels with them.  ``backtrack`` walks the choice table in numpy (the
host solve on the CPU), and ``exhaustive_oracle`` brute-forces small
problems for the tests.
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
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
    if not choices:
        return v, torch.zeros((0, W + 1), dtype=torch.int32, device=dev)
    return v, torch.stack(choices)


def backtrack(choices: np.ndarray, costs: np.ndarray, values: np.ndarray
              ) -> Tuple[np.ndarray, int]:
    """Per-camera option indices from the choice table, starting at the
    best w (first on ties).  Returns (picks (I,) int32, that w)."""
    choices = np.asarray(choices)
    costs = np.asarray(costs)
    I = choices.shape[0]
    w0 = int(np.argmax(np.asarray(values)))
    w = w0
    picks = np.zeros(I, np.int32)
    for i in range(I - 1, -1, -1):
        j = int(choices[i, w])
        picks[i] = j
        w = max(w - int(costs[j]), 0)
    return picks, w0


def backtrack_device(choices: torch.Tensor, costs: torch.Tensor,
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


def exhaustive_oracle(util: np.ndarray, costs: np.ndarray, W: int
                      ) -> Tuple[np.ndarray, float]:
    """Brute force over J^I assignments (tests only)."""
    util = np.asarray(util)
    costs = np.asarray(costs)
    I, J = util.shape
    best, best_v = None, -np.inf
    for assign in itertools.product(range(J), repeat=I):
        if sum(costs[j] for j in assign) > W:
            continue
        v = sum(util[i, j] for i, j in enumerate(assign))
        if v > best_v:
            best_v, best = v, assign
    return np.array(best), float(best_v)
