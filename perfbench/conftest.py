"""Fixtures of the benchmark's CPU tests: a cell cut to a size the CPU
runs in seconds (2 cameras, windows of 2 slots, a sample of 3 windows,
one window of each part of a traced run)."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_SEED = 2 ** 31 + 7          # above 32 signed bits, as a run's seed may be


def tiny(cell, cameras: int = 2):
    """``cell`` with its configuration cut for the CPU."""
    cell = copy.copy(cell)
    cfg = copy.deepcopy(cell.config)
    cfg["scene"]["num_cameras"] = cameras
    cfg["stream"]["window_slots"] = 2
    cfg["check"].update(windows=3, first_windows=1)
    cell.config = cfg
    traffic = dict(cell.traffic)
    traffic["span_windows"] = 1
    traffic["trace_windows"] = 1
    cell.traffic = traffic
    return cell


@pytest.fixture
def tiny_cell():
    from perfbench.core import bench
    return tiny(bench.find_cell(bench.load_benchmark(), "ds16.stream"))
