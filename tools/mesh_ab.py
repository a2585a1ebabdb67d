#!/usr/bin/env python3
"""The camera-sharded episode on several cards against one card.

Run from the repository root on a machine with N cards:

    python3 tools/mesh_ab.py --ranks 4 [--cameras 16] [--slots 11]

The script builds the kernels, runs the graph-replayed episode of the
five methods unsharded on card 0 (``SystemConfig()`` defaults, scene seed
7, the first ``--slots`` slots of ``bandwidth_trace("medium", 11,
seed=3)`` scaled by C/5, the committed detectors, the untrained utility
MLP of ``PRNGKey(0)``, thresholds 10 / 50 Kbps scaled by C/5, the
linspace jcab table), then starts ``python -m torch.distributed.run
--standalone --nproc-per-node N`` on itself: every rank runs the same
episodes on its block of the camera mesh (NCCL, the (a, c) gather inside
the CUDA graphs).  Each side times every method with CUDA events around
whole runs (harvest included; one warm-up run that captures, then the
median of 5; the ranks' runs start together).  Printed: the card's name
and power limit, per method the largest |difference| of the mesh's logs
from one card's (with whether they are bitwise equal), and both ms/slot.
It fails if a difference exceeds 1e-5 of the log's scale (the JAX
package's bound for its sharded episode).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
METHODS = ("deepstream", "deepstream_no_elastic", "jcab", "reducto",
           "static")
LOG_KEYS = ("utility", "mean_f1", "bytes", "alloc_kbps", "extra", "area")
TIMED = 5
TOL = 1e-5


def run_side(C: int, T: int, sharded: bool) -> dict:
    """{method: (logs, [ms/slot of each timed run])} on this process's
    card, ``sharded`` over the camera mesh of every rank of the process
    group."""
    import numpy as np
    import torch
    from repro_torch.common import prng
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.core.utility import init_utility_mlp
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            bandwidth_trace)
    from repro_torch.models.detector import load_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    s = DeepStreamSystem(SystemConfig(scene=SceneConfig(seed=7,
                                                        num_cameras=C),
                                      shard="on" if sharded else "off"),
                         load_detector("light", dev),
                         load_detector("server", dev), device=dev)
    mesh = s.mesh
    s.mlp = init_utility_mlp(prng.PRNGKey(0, device=dev))
    s.tau_wl, s.tau_wh = 10.0 * C / 5, 50.0 * C / 5
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    trace = bandwidth_trace("medium", 11, seed=3)[:T] * C / 5
    out = {}
    for method in METHODS:
        logs = s.run_episode(DeviceScene(s.cfg.scene, device=dev, mesh=mesh),
                             trace, method)
        ms = []
        for _ in range(TIMED):
            scene = DeviceScene(s.cfg.scene, device=dev, mesh=mesh)
            if mesh is not None:
                torch.distributed.barrier()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            got = s.run_episode(scene, trace, method)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / T)
            for k in LOG_KEYS:
                if not np.array_equal(got[k], logs[k]):
                    raise AssertionError(f"{method}: a re-run differs")
        out[method] = ({k: np.asarray(logs[k]).tolist() for k in LOG_KEYS},
                       ms)
    return out


def worker(args) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_distributed("cuda")
    try:
        out = run_side(args.cameras, args.slots, True)
        if torch.distributed.get_rank() == 0:
            Path(args.out).write_text(json.dumps(out))
    finally:
        mesh_mod.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cameras", type=int, default=16)
    ap.add_argument("--slots", type=int, default=11)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=str(ROOT / "build" / "mesh_ab.json"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("mesh_ab: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.ranks:
        print(f"mesh_ab: {args.ranks} ranks need as many cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(" | ".join(smi))
    build.build()
    one = run_side(args.cameras, args.slots, False)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(args.ranks), str(Path(__file__).resolve()),
         "--worker", "--cameras", str(args.cameras), "--slots",
         str(args.slots), "--out", args.out], env=env, cwd=ROOT,
        timeout=1200)
    if p.returncode != 0:
        print(f"mesh_ab: the {args.ranks}-rank run failed", file=sys.stderr)
        return 1
    sharded = json.loads(Path(args.out).read_text())
    tag = f"[{smi[0]}]"
    worst = 0.0
    for method in METHODS:
        (la, ma), (lb, mb) = one[method], sharded[method]
        diffs, bitwise = {}, True
        for k in LOG_KEYS:
            a, b = np.asarray(la[k]), np.asarray(lb[k])
            bitwise &= bool(np.array_equal(a, b))
            scale = max(1.0, float(np.max(np.abs(a))))
            diffs[k] = float(np.max(np.abs(a - b)))
            worst = max(worst, diffs[k] / scale)
        print(f"mesh {args.ranks} ranks vs one card, {method} C="
              f"{args.cameras} T={args.slots}: "
              + ("bitwise equal" if bitwise else "max |diff| " + " ".join(
                  f"{k}={v:.3g}" for k, v in diffs.items()))
              + f"; ms/slot median one card {statistics.median(ma):.3f} "
              f"(min {min(ma):.3f}), {args.ranks} ranks "
              f"{statistics.median(mb):.3f} (min {min(mb):.3f}), "
              f"{TIMED} runs {tag}")
    if worst > TOL:
        print(f"mesh_ab: the mesh's logs differ by {worst:.3g} of their "
              f"scale > {TOL}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
