#!/usr/bin/env python3
"""ms/slot of the graph-replayed episode for one source tree, to compare
two trees on one CUDA card.

Run from the repository root, once per tree and in turns (A, B, B, A),
one after another on one card:

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    for t in build/parent . . build/parent; do
        python3 tools/graph_ab.py $t; done

``repro_torch`` is imported from ``<tree>/src`` (its kernels build into
``<tree>/build/kernels``).  Times the four methods at C=5 and 16, T=8
(scene seed 7, the first 8 slots of ``bandwidth_trace("medium", 11,
seed=3)`` scaled by C/5, ``SystemConfig()`` defaults, the untrained
utility MLP of ``PRNGKey(0)``, thresholds 10 / 50 Kbps scaled by C/5):
one warm-up run (the capture), then the median of 5 runs, each timed
with CUDA events around the whole run, harvest included.  Prints the
card's name and power limit, then one line per tree.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else ".").resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.common import prng
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.core.utility import init_utility_mlp
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            bandwidth_trace)
    from repro_torch.kernels import build
    from repro_torch.models.detector import load_detector
    if not torch.cuda.is_available():
        print("graph_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    dev = torch.device("cuda")
    light, server = load_detector("light", "cpu"), load_detector("server",
                                                                 "cpu")
    trace = bandwidth_trace("medium", 11, seed=3)[:8]
    out = {}
    for C in (5, 16):
        s = DeepStreamSystem(SystemConfig(scene=SceneConfig(
            seed=7, num_cameras=C)), light, server, device=dev)
        s.mlp = init_utility_mlp(prng.PRNGKey(0, device=dev))
        s.tau_wl, s.tau_wh = 10.0 * C / 5, 50.0 * C / 5
        s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(
            np.float32)
        tr = trace * C / 5
        for m in ("deepstream", "jcab", "reducto", "static"):
            s.run_episode(DeviceScene(s.cfg.scene, device=dev), tr, m)
            ts = []
            for _ in range(5):
                scene = DeviceScene(s.cfg.scene, device=dev)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                s.run_episode(scene, tr, m)
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b) / len(tr))
            out[f"{m} C={C}"] = statistics.median(ts)
    print(f"{root.name}: ms/slot " + " ".join(f"{k} {v:.3f}"
                                              for k, v in out.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
