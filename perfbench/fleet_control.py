"""The correctness check's readings at a cell's own size, many seeds in one
process: for each seed, a short window of the program at the cell's load,
then its ``log_gap`` against the reference (the lower reading), and, on
the first ``--control-seeds`` seeds, the gap of the control: the reference
itself with both detectors' convolutions in bfloat16, the precision below
the configuration's float32, put in the program's place on the same
windows (the upper reading).  ``PERF.md`` gives the readings each limit
was set from.

    python3 perfbench/fleet_control.py --workload ds16.stream --seconds 5 \\
        --seeds 11 12 13 --control-seeds 3

Prints one JSON line per seed and needs the card.  The benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.core import bench  # noqa: E402
from perfbench.reference import fleet as ref_fleet  # noqa: E402


def control_gaps(cell, seed: int, device, outcome, driver) -> dict:
    """The bfloat16 control's gaps on the windows the run compared."""
    import torch
    rd = outcome.readings
    windows = rd.counters["checked_windows"]
    n = int(cell.config["stream"]["window_slots"])
    stream = driver.Stream(cell.traffic, int(cell.config["scene"][
        "num_cameras"]), seed)
    # the control replays the elastic state from the same areas the
    # reference followed (the program's logged areas outside the windows)
    area = driver.program_area(rd)
    ctl = driver.reference_logs(cell, seed, device, stream, windows, n,
                                area, torch.bfloat16)
    return ref_fleet.compare(ctl, rd.reference)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fleet_control.py needs the card", file=sys.stderr)
        return 2
    cell = bench.find_cell(bench.load_benchmark(), args.workload)
    driver = bench.driver_of(cell)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        out = driver.run(cell, seed, args.seconds, False, "cuda", t0)
        rd = out.readings
        row = {"workload": args.workload, "seed": seed,
               "log_gap": out.checks[0].value,
               "gaps": rd.counters["log_gaps"],
               "windows_served": len(rd.durations("serve_window")),
               "checked_windows": rd.counters["checked_windows"],
               "checks": {c.name: [c.value, c.limit, c.ok]
                          for c in out.checks}}
        t1 = time.perf_counter()
        if i < args.control_seeds:
            gaps = control_gaps(cell, seed, "cuda", out, driver)
            row["control_gaps"] = gaps
            row["control_log_gap"] = driver.log_gap(gaps)
        row["seconds"] = [round(t1 - t0, 3),
                          round(time.perf_counter() - t1, 3)]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
