"""Train a reduced zoo backbone with the PyTorch port, then resume it.

    PYTHONPATH=src python examples/train_backbone_torch.py [--arch granite-8b]
    PYTHONPATH=src python examples/train_backbone_torch.py --device cpu --steps 8

The counterpart of ``train_backbone.py``, through
``repro_torch.launch.train``: config -> LM (per-layer recompute) -> the
token pipeline -> the microbatched AdamW train step -> atomic checkpoints
-> restore-and-continue.  Each phase is one launcher process.
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when omitted")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    args = ap.parse_args(argv)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    common = ["--arch", args.arch, "--smoke", "--batch", "8", "--seq", "128",
              "--microbatches", "2", "--ckpt-dir", ckpt]
    if args.device:
        common += ["--device", args.device]
    launch = [sys.executable, "-m", "repro_torch.launch.train"]
    print(f"== phase 1: train {args.arch} (reduced) for {args.steps // 2} "
          "steps ==")
    subprocess.run(launch + common + ["--steps", str(args.steps // 2),
                                      "--ckpt-every", "20"],
                   env=env, check=True)
    print("\n== phase 2: simulate restart — resume from latest checkpoint ==")
    subprocess.run(launch + common + ["--steps", str(args.steps),
                                      "--resume"], env=env, check=True)


if __name__ == "__main__":
    main()
