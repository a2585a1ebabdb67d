"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration, traffic and metrics are found by name from
``BENCHMARK.json`` (``perfbench/core/bench.py``).  With ``--trace 0`` the
line's metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics.  The numbers the correctness check compared are printed
with their limits as the last lines on standard error and under the
line's last key, ``check``.  The run needs the cards the cell asks for
and exits with another code than 0, printing no result, without them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# every build and kernel cache of the program inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton")):
    os.environ[var] = str(ROOT / sub)
os.environ["USE_FLAX"] = "0"
# one process, few threads: no OpenMP pool spinning beside the host loop
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

from perfbench.core import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_origin = T_START - bench.process_start_offset()

    cell = bench.find_cell(bench.load_benchmark(), args.workload)
    t_import = time.perf_counter()
    import torch
    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = bench.driver_of(cell)
    outcome = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_origin)
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = bench.read_metrics(entries, outcome.readings)
    found = bench.forbidden_loaded()
    if found:
        print("the benchmark's process holds forbidden modules: "
              + ", ".join(found), file=sys.stderr)
        return 3
    line = bench.result_line(outcome, metrics, bool(args.trace))
    rd = outcome.readings
    print(f"setup parts s: process start to harness {t_import - t_origin:.3f}"
          f", torch import {t_torch - t_import:.3f}", file=sys.stderr)
    for note in rd.notes:
        print(note, file=sys.stderr)
    for c in outcome.checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
