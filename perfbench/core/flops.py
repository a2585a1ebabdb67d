"""Floating-point operations of the fleet's detectors, counted from their
widths: every convolution is 2 x Cout x Cin x k^2 multiply-adds per output
pixel, at stride 2 with "SAME" padding for the four 3 x 3 layers, then the
1 x 1 head of 5 outputs at stride 1."""
from __future__ import annotations

from typing import Sequence


def detector_flops(widths: Sequence[int], H: int, W: int) -> int:
    """One frame of a detector of ``widths`` (4 conv widths)."""
    total, cin, h, w = 0, 1, H, W
    for cout in widths:
        h, w = -(-h // 2), -(-w // 2)
        total += 2 * cout * cin * 9 * h * w
        cin = cout
    return total + 2 * 5 * cin * h * w


def fleet_slot_flops(config) -> int:
    """One camera-slot of the deepstream path: the light detector on the
    first and last frame (ROIDet), the server detector on ``eval_frames``
    frames."""
    sc, det = config["scene"], config["detectors"]
    H, W = int(sc["height"]), int(sc["width"])
    return (2 * detector_flops(det["light_widths"], H, W)
            + int(config["system"]["eval_frames"])
            * detector_flops(det["server_widths"], H, W))
