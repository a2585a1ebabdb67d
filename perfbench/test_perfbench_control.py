"""The correctness check's control at a size the CPU holds: the plain
reference itself with the detectors' convolutions in bfloat16 (the
precision below the configuration's float32), put in the program's place,
fails the check's limit.  On the card it runs at each cell's own size
through ``perfbench/fleet_control.py``."""
import torch

from perfbench import fleet_control
from perfbench.conftest import TINY_SEED, tiny
from perfbench.core import bench
from perfbench.drivers import fleet_stream as fs

torch.set_num_threads(1)


def test_bfloat16_control_fails_the_limit():
    cell = tiny(bench.find_cell(bench.load_benchmark(), "ds16.stream"),
                cameras=4)
    out = fs.run(cell, TINY_SEED, 0.0, False, "cpu", 0.0, max_windows=2)
    assert out.checks[0].ok and out.checks[0].value == 0.0
    gaps = fleet_control.control_gaps(cell, TINY_SEED, "cpu", out, fs)
    limit = cell.config["check"]["log_gap_limit"]
    assert fs.log_gap(gaps) > limit, gaps
