#!/usr/bin/env python3
"""How long a traced dry-run cell would take, from traces at a cut depth.

Run from the repository root, one cell at a time and nothing else on the
host (the seconds are the host's):

    PYTHONPATH=src python3 tools/trace_depth.py ARCH SHAPE MESH [--units 2] [--device cpu]

``MESH`` is the sweep's (``single``, ``multi`` or ``DxM``).  Rank 0's
step of the cell (``launch.dryrun.trace_cell`` at the sweep's run config)
is traced at 1 and, with ``--units 2``, 2 repeating units of depth, each
in a process of its own: a layer; a superblock of the VLM
(``cross_attn_every`` layers) or of xLSTM (``slstm_every`` layers); one
encoder and one decoder layer of seamless.  The trace's aten ops grow
linearly in the units, so two depths give the published depth's ops
exactly (one depth gives an upper bound: the embedding and the loss
counted once a unit).  Printed as one JSON line: the ops and seconds of
each depth, the published depth's ops, and its seconds at the cut
traces' seconds an op.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cut_run(arch: str, shape: str, mesh: str, units: int):
    """(the sweep's run config at ``units`` repeating units, the units of
    the published depth)."""
    from repro_torch.launch import sweep
    from repro_torch.launch.specs import arch_run_config
    kind = "multi" if len(sweep.mesh_shape(mesh)) == 3 else "single"
    run = arch_run_config(arch, shape, kind)
    cfg = run.model
    if cfg.encdec is not None:
        e = cfg.encdec
        m = cfg.replace(num_layers=2 * units, encdec=type(e)(
            enc_layers=units, dec_layers=units,
            enc_seq_factor=e.enc_seq_factor))
        full = e.enc_layers
    elif cfg.vlm is not None or cfg.xlstm is not None:
        p = (cfg.vlm.cross_attn_every if cfg.vlm is not None
             else cfg.xlstm.slstm_every)
        m, full = cfg.replace(num_layers=p * units), cfg.num_layers / p
    else:
        m, full = cfg.replace(num_layers=units), cfg.num_layers
    return run.replace(model=m), full


def one(args) -> dict:
    from repro_torch.launch import dryrun, sweep
    run, full = cut_run(args.arch, args.shape, args.mesh, args.one)
    res = dryrun.trace_cell(args.arch, args.shape,
                            sweep.mesh_shape(args.mesh), device=args.device,
                            run=run)
    return {"units": args.one, "full_units": full, "ops": res["ops"],
            "trace_s": res["trace_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh")
    ap.add_argument("--units", type=int, default=2, choices=(1, 2))
    ap.add_argument("--device", default=None,
                    help="the traced tensors' device type (default: the "
                         "card's; cpu on a host without one)")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    if args.one is not None:
        print(json.dumps(one(args)))
        return 0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for u in range(1, args.units + 1):
        cmd = [sys.executable, str(Path(__file__).resolve()), args.arch,
               args.shape, args.mesh, "--one", str(u)]
        cmd += ["--device", args.device] if args.device else []
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           check=True)
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    full = runs[0]["full_units"]
    ops = (runs[0]["ops"] * full if len(runs) == 1 else
           runs[0]["ops"] + (full - 1) * (runs[1]["ops"] - runs[0]["ops"]))
    s_per_op = (sum(r["trace_s"] for r in runs)
                / sum(r["ops"] for r in runs))
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": args.mesh, "runs": runs,
                      "full_ops": int(ops),
                      "full_s": round(ops * s_per_op, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
