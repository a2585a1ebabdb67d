#!/usr/bin/env python3
"""Design timings of B1 (edge_motion) and B3 (knapsack_dp) on one CUDA
card: readings that choose a design or a constant once, kept out of
``chip_smoke.py``'s every-run checks.

Run from the repository root:

    python3 tools/kernel_probe.py b1 [plans] [b3route] [--tag NAME]

  b1       B1 under its launch plan at chip_smoke.EM_TIMED, three profiler
           windows of 100 calls each, one kernel per call.  ``repro_torch``
           is taken from PYTHONPATH when it is set, so that two trees' B1
           can be timed in one session (run them A, B, B, A);
  plans    B1 at (5, 10, 96, 160) and (16, 10, 96, 160) under its launch
           plan, whole-row segments and 40- and 32-column segments, timed
           in turns (plan, others, plan): the readings that order
           ``ops.BLOCK_WORDS``;
  b3route  the route the fused B3 solve replaced (the sweep kernel, then
           ``ref.backtrack_device``) at chip_smoke.DP_TIMED: its kernels
           per solve and their time on the card.

Prints the card's name and power limit, one line per reading and one JSON
line, also written to ``chiprun_out/kernel_probe-<NAME>.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.append(str(ROOT / "src"))     # after PYTHONPATH's trees

import chip_smoke as cs  # noqa: E402


def b1_times(torch, dev, sms: int, tag: str) -> dict:
    from repro_torch.kernels.edge_motion import ops as em_ops
    out = {}
    for C, M, H, W in cs.EM_TIMED:
        fr = cs.em_timed_frames(torch, dev, C, M, H, W)
        ts = [cs.one_kernel_ms(torch, lambda: em_ops.edge_motion_cuda(
            fr, block_size=8, edge_thresh=0.35), 100,
            "edge_motion_kernel")[0] for _ in range(3)]
        plan = em_ops.plan(C, M, H, W, 8, sms)
        print(f"b1 {(C, M, H, W)} plan {plan}: " + "/".join(
            f"{t * 1e3:.3f}" for t in ts) + f" us (median "
            f"{statistics.median(ts) * 1e3:.3f}) {tag}")
        out[str((C, M, H, W))] = {"plan": list(plan), "ms": ts}
    return out


def b1_plans(torch, dev, sms: int, tag: str) -> dict:
    from repro_torch.kernels.edge_motion import ops as em_ops
    out = {}
    for C, M, H, W in ((5, 10, 96, 160), (16, 10, 96, 160)):
        fr = cs.em_timed_frames(torch, dev, C, M, H, W)
        plan = em_ops.plan(C, M, H, W, 8, sms)
        others = [p for p in ((W // 8, M - 1), (5, M - 1), (4, M - 1))
                  if p != plan]
        times = {}
        for p in [plan] + others + [plan]:
            times.setdefault(str(p), []).append(cs.one_kernel_ms(
                torch, lambda p=p: em_ops._launch(fr, 8, 0.35, p), 100,
                "edge_motion_kernel")[0])
        print(f"b1 plans at {(C, M, H, W)} (segment blocks, pairs per "
              "chunk): " + ", ".join(
                  f"{k} " + "/".join(f"{t * 1e3:.3f}" for t in v) + " us"
                  for k, v in times.items()) + f" {tag}")
        out[str((C, M, H, W))] = times
    return out


def b3_route(torch, dev, tag: str) -> dict:
    import numpy as np
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.knapsack_dp import ref as dp_ref
    costs = torch.tensor(cs.DP_COSTS, dtype=torch.int32, device=dev)
    J = len(cs.DP_COSTS)
    out = {}
    for I, wp1 in cs.DP_TIMED:
        W = wp1 - 1
        util = torch.from_numpy(np.random.default_rng(I * 1000 + W).uniform(
            0, 1, (I, J)).astype(np.float32)).to(dev)
        wg = torch.tensor(W // 2, dtype=torch.int32, device=dev)

        def route(u=util, w=wg, W=W):
            v, c = dp_ops.knapsack_dp_cuda(u, costs, W)
            return dp_ref.backtrack_device(c, costs, v, w)

        ms, per_solve = cs.device_ms_count(torch, route, 20)
        print(f"b3 sweep kernel + backtrack_device ({I}, {J}, {wp1}) Wg "
              f"{W // 2}: {per_solve:g} kernels per solve, {ms * 1e3:.2f} us "
              f"on the card {tag}")
        out[str((I, J, wp1))] = {"kernels_per_solve": per_solve, "ms": ms}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parts", nargs="+", choices=("b1", "plans", "b3route"))
    ap.add_argument("--tag", default="probe")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import repro_torch
    print(f"{smi}; repro_torch from {Path(repro_torch.__file__).parent}")
    tag = f"[{smi}] ({args.tag})"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {"tag": args.tag, "device": smi}
    if "b1" in args.parts:
        res["b1"] = b1_times(torch, dev, sms, tag)
    if "plans" in args.parts:
        res["plans"] = b1_plans(torch, dev, sms, tag)
    if "b3route" in args.parts:
        res["b3route"] = b3_route(torch, dev, tag)
    line = json.dumps(res)
    print(line)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / f"kernel_probe-{args.tag}.json").write_text(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
