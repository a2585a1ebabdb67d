"""Quickstart for the PyTorch port: the DeepStream pipeline on one slot.

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The counterpart of ``quickstart.py``.  It restores the committed light and
server detectors (``artifacts/detector_{light,server}``) instead of
training them, profiles the utility function on a few slots, then runs one
slot of the deepstream method through ``DeepStreamSystem.run()``:
synthetic co-located cameras -> ROIDet (the edge_motion and cc_label
kernels and the light detector) -> content features (a, c) -> utility
prediction -> the knapsack_dp allocation -> the tx_codec encode -> server
detection F1.  It prints each camera's features and allocation, the slot's
logs and each kernel's launches in the slot.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

W_KBPS = 900.0           # the slot's uplink, as in quickstart.py


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--cameras", type=int, default=5)
    ap.add_argument("--profile-slots", type=int, default=2,
                    help="slots profiled to fit the utility MLP (0: keep "
                         "the untrained MLP)")
    ap.add_argument("--mlp-steps", type=int, default=300)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.common import prng
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.core.utility import init_utility_mlp
    from repro_torch.data.synthetic import (DeviceScene, MultiCameraScene,
                                            SceneConfig, segments_device)
    from repro_torch.kernels.cc_label import ops as cc_ops
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.models.detector import load_detector

    dev = torch.device(args.device)
    print(f"== DeepStream quickstart (PyTorch port, {dev}) ==")
    light, server = load_detector("light", dev), load_detector("server", dev)
    print("restored the committed detectors (artifacts/detector_light, "
          "artifacts/detector_server)")
    C = args.cameras
    sysd = DeepStreamSystem(SystemConfig(scene=SceneConfig(
        seed=7, num_cameras=C)), light, server, device=dev)
    if args.profile_slots:
        print("profiling the utility function (paper section 5.1)...")
        info = sysd.profile(MultiCameraScene(SceneConfig(
            seed=42, num_cameras=C)), num_slots=args.profile_slots,
            mlp_steps=args.mlp_steps)
        print(f"  profiled: mlp_mse={info['mlp_mse']:.4f} "
              f"tau_wl={info['tau_wl']:.0f}Kbps "
              f"tau_wh={info['tau_wh']:.0f}Kbps")
    else:
        sysd.mlp = init_utility_mlp(prng.PRNGKey(0, device=dev))
        print("utility MLP: untrained (--profile-slots 0)")

    scene = DeviceScene(sysd.cfg.scene, device=dev)
    frames = segments_device(scene.cfg, scene.params, scene.key, 0,
                             gt_pad=scene.G)[0]
    roi = sysd.camera_features(frames)
    a, c = roi.area_ratio.cpu().numpy(), roi.confidence.cpu().numpy()
    print("\nROIDet content features per camera:")
    for i in range(C):
        print(f"  cam{i}: ROI area ratio a={a[i]:.2f}, confidence "
              f"c={c[i]:.2f}")

    counters = {"edge_motion": em_ops, "cc_label": cc_ops,
                "knapsack_dp": dp_ops, "tx_codec": tx_ops}
    for mod in counters.values():
        mod.LAUNCHES = 0
    logs = sysd.run(scene, np.array([W_KBPS]), "deepstream")
    launches = {k: mod.LAUNCHES for k, mod in counters.items()}
    print(f"\none slot of deepstream under W={W_KBPS:.0f}Kbps: allocated "
          f"{logs['alloc_kbps'][0]:.0f}Kbps (elastic extra "
          f"{logs['extra'][0]:.1f}), utility {logs['utility'][0]:.3f}, mean "
          f"F1 {logs['mean_f1'][0]:.3f}, {logs['bytes'][0] / 1024:.0f} KiB")
    print("kernel launches in the slot: "
          + " ".join(f"{k} {v}" for k, v in launches.items()))
    return {"logs": logs, "launches": launches,
            "features": {"a": a, "c": c}}


if __name__ == "__main__":
    main()
