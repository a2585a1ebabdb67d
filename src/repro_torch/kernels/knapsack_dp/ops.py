"""Knapsack DP entry points: the static capacity bucket and the device
solve (plain sweep + on-device backtrack)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.knapsack_dp import ref


def bucket_capacity(Wg: int) -> int:
    """A grid capacity bucketed up to the next multiple of 128, minus 1."""
    return ((Wg + 1 + 127) // 128) * 128 - 1


def solve_device(util: torch.Tensor, costs: torch.Tensor, Wg: torch.Tensor,
                 *, w_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """DP sweep at the static capacity ``w_cap`` and a backtrack bounded by
    the 0-d capacity ``Wg`` (<= w_cap).  Returns (picks (I,), total)."""
    vals, choices = ref.knapsack_dp_ref(util, costs, int(w_cap))
    return ref.backtrack(choices, costs, vals, Wg)
