"""Bytes and operations of the port's hand-written kernels at a launch's
shape: the arithmetic behind ``chip_smoke.py``'s bounds, copied so that
the yardstick stays with the benchmark.  Each input byte is read once and
each output byte written once.

Kernels are found in the card's records by these name fragments; a launch
shape comes from the driver, which knows the configuration it runs.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from perfbench.core.peaks import bound_s

# the kernels' names in the card's records
KERNEL_NAMES: Dict[str, str] = {
    "edge_motion": "edge_motion_kernel",
    "tx_codec": "tx_codec_kernel",
    "knapsack_dp": "knapsack_dp_",
    "cc_label": "cc_label_kernel",
}


def edge_motion(C: int, M: int, H: int, W: int, bs: int) -> Tuple[int, int]:
    """B1 over (C, M) frames: frames read, (C, M-1) block sums written;
    the Sobel pass (15 operations a pixel) and the XOR and block sum (2 a
    pixel of each pair)."""
    px = C * M * H * W
    return (4 * (px + C * (M - 1) * (H // bs) * (W // bs)),
            px * 15 + C * (M - 1) * H * W * 2)


def tx_codec(C: int, N: int, H: int, W: int) -> Tuple[int, int]:
    """B2: frames and noise read, decoded frames written; pool sum and
    divide, quantise, fused noise add and clip (8 operations a pixel)."""
    px = C * N * H * W
    return 4 * 3 * px, px * 8


def knapsack_dp(I: int, J: int, wp1: int) -> Tuple[int, int]:
    """B3's solve: the utility table and costs read, picks and the total
    written; three operations per (camera, option, capacity) and two per
    capacity of the backtrack's scan."""
    return 4 * (I * J + J + 1) + 8 * I + 4, I * J * wp1 * 3 + 2 * wp1


def cc_label(C: int, M: int, N: int, passes: int = 1) -> Tuple[int, int]:
    """cc_label: the mask read (a byte a cell) and the labels written; four
    neighbour minimums and a compare per cell and pass.  The passes depend
    on the masks; one pass is the least any mask needs."""
    return 5 * C * M * N, 5 * passes * C * M * N


COST: Dict[str, Callable[..., Tuple[int, int]]] = {
    "edge_motion": edge_motion, "tx_codec": tx_codec,
    "knapsack_dp": knapsack_dp, "cc_label": cc_label}


def launch_bound_s(kernel: str, shape) -> float:
    """The bound of one launch of ``kernel`` at ``shape`` (float32 rate)."""
    nbytes, ops = COST[kernel](*shape)
    return bound_s(nbytes, ops)
