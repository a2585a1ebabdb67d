"""End-to-end run of the PyTorch port (the paper's kind: serving).

    PYTHONPATH=src python examples/serve_pipeline_torch.py              # the card
    PYTHONPATH=src python examples/serve_pipeline_torch.py --device cpu

The counterpart of ``serve_pipeline.py``: the DeepStream ingest tier
streams ROI-cropped segments from correlated cameras under a fluctuating
bandwidth trace (elastic transmission active), and the analytics tier
serves a zoo backbone (a reduced qwen1.5-4b, ``smoke_config``) with
continuous-batched requests derived from the per-camera detections.  The
detectors are the committed ``artifacts/detector_{light,server}``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--cameras", type=int, default=5)
    ap.add_argument("--slots", type=int, default=5)
    ap.add_argument("--profile-slots", type=int, default=2)
    ap.add_argument("--mlp-steps", type=int, default=300)
    ap.add_argument("--requests", type=int, default=8)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.data.synthetic import (MultiCameraScene, SceneConfig,
                                            bandwidth_trace)
    from repro_torch.models.detector import load_detector
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device(args.device)
    C = args.cameras
    print("== ingest tier: DeepStream streaming loop ==")
    sysd = DeepStreamSystem(
        SystemConfig(scene=SceneConfig(seed=9, num_cameras=C),
                     eval_frames=3),
        load_detector("light", dev), load_detector("server", dev),
        device=dev)
    sysd.profile(MultiCameraScene(SceneConfig(seed=42, num_cameras=C)),
                 num_slots=args.profile_slots, mlp_steps=args.mlp_steps)
    scene = MultiCameraScene(sysd.cfg.scene)
    trace = bandwidth_trace("low", args.slots, seed=2)
    logs = sysd.run(scene, trace, method="deepstream")
    print(f"  {len(trace)} slots, mean utility {logs['utility'].mean():.3f}, "
          f"mean bytes/slot {logs['bytes'].mean() / 1024:.0f} KiB, "
          f"elastic extra Kbps per slot: {np.round(logs['extra'], 1)}")

    print("\n== analytics tier: batched backbone serving ==")
    cfg = smoke_config("qwen1.5-4b")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServeEngine(lm, params, batch_slots=4, max_seq=64, device=dev)
    rng = np.random.default_rng(0)
    # one request per camera per high-utility slot (token ids stand in for
    # the ROI-token stream a production frontend would emit)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 24,
                                               dtype=np.int32),
                    max_new_tokens=8)
            for i in range(args.requests)]
    stats = eng.run(reqs)
    print(f"  served {stats['requests']} requests, {stats['tokens']} tokens "
          f"in {stats['steps']} engine steps "
          f"({stats['tok_per_s']:.1f} tok/s on {dev})")
    return {"logs": logs, "stats": stats, "requests": reqs}


if __name__ == "__main__":
    main()
