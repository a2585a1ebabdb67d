#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  ``python3 chip_smoke.py``  (``--profile`` adds a torch.profiler
pass over one episode).  It needs no JAX.  In order it prints:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build time (nvcc for sm_90a, every source at once);
  3. each hand-written kernel against its plain PyTorch version on the card
     at the episode's shapes: edge_motion exact, tx_codec <= 1e-6;
  4. the four-method whole-trace episode at the default configuration
     (5 cameras, 96x160, 10 frames per slot, T=8): finite logs, F1 in
     [0, 1], both kernels' launch counters rising on the main path, and the
     card's logs equal to the port's own CPU run to <= 1e-5;
  5. ms/slot per method at C=5 and C=16, and each kernel's time beside its
     plain version's and its bound, tagged with the card and power limit;
  6. one JSON line of kernel records, then the device line (last).

Any mismatch ends the run with a non-zero exit code; no phase's failure is
caught.  Without a CUDA device it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
METHODS = ("deepstream", "jcab", "reducto", "static")
T_SLOTS = 8


def cuda_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(prof, name=None) -> float:
    """Kernel time recorded on the card (CUPTI) in a profiler window: every
    kernel, or those whose name contains ``name``."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation
               and (name is None or name in e.key))


def device_ms(torch, fn, iters: int, name=None) -> float:
    """Mean kernel time on the card per call of ``fn`` (launch gaps on the
    host excluded), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = device_us(prof, name)
    if not us > 0.0:
        raise AssertionError(f"the profiler recorded no kernel time for "
                             f"{name or 'the plain version'}")
    return us / 1e3 / iters


def max_log_diff(ref: dict, got: dict, keys, tol: float) -> dict:
    """Per-key max |got - ref|; raises past tol * max(1, |ref|max) (the
    JAX package's harness rule)."""
    import numpy as np
    out = {}
    for k in keys:
        r, g = np.asarray(ref[k], float), np.asarray(got[k], float)
        d = float(np.max(np.abs(r - g))) if r.size else 0.0
        scale = max(1.0, float(np.max(np.abs(r))) if r.size else 1.0)
        if not d <= tol * scale:
            raise AssertionError(f"key {k}: card vs CPU diff {d} > "
                                 f"{tol * scale}")
        out[k] = d
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one deepstream episode")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path cannot run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.common import prng
    from repro_torch.core import codec
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.core.utility import init_utility_mlp
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            bandwidth_trace, segments_device)
    from repro_torch.kernels import build
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.edge_motion import ref as em_ref
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    from repro_torch.models.detector import load_detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    tag = f"[{smi}]"

    t0 = time.perf_counter()
    libs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{len(libs)} sources (nvcc, sm_90a, in parallel)")

    # -- 3. kernels vs their plain versions on the card -----------------
    bs, thr = 8, 0.35
    worst = {"edge_motion": 0.0, "tx_codec": 0.0}
    for C in (5, 16):
        scene = DeviceScene(SceneConfig(seed=7, num_cameras=C), device=dev)
        frames = segments_device(scene.cfg, scene.params, scene.key, 3,
                                 gt_pad=scene.G)[0]
        ref_frames = segments_device(scene.cfg, scene.params, scene.key, 2,
                                     gt_pad=scene.G)[0][:, -1:]
        gen = torch.Generator(device=dev).manual_seed(C)
        noise_fr = torch.rand(frames.shape, device=dev, generator=gen)
        cases = {"roidet": frames,
                 "reducto": torch.cat([ref_frames, frames], dim=1),
                 "uniform": noise_fr}
        for name, fr in cases.items():
            got = em_ops.edge_motion_cuda(fr.contiguous(), block_size=bs,
                                          edge_thresh=thr)
            torch.cuda.synchronize()
            want = em_ref.segment_motion_ref(fr, block_size=bs,
                                             edge_thresh=thr)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst["edge_motion"] = max(worst["edge_motion"], err)
            print(f"edge_motion vs plain C={C} {name} {tuple(fr.shape)}: "
                  f"max |diff| {err} (sum {float(want.sum()):.0f})")
            if err != 0.0:
                raise AssertionError("edge_motion differs from its plain "
                                     "version")
        keys = prng.fold_in(prng.PRNGKey(11, device=dev),
                            torch.arange(C, device=dev))
        noise = prng.normal(keys, frames.shape[1:])
        rates = torch.tensor([50, 100, 200, 400, 800, 1000], device=dev,
                             dtype=torch.float32)[torch.arange(C, device=dev)
                                                  % 6]
        roi = torch.full((C,), 96.0 * 160.0, device=dev)
        levels, sigma, _ = codec.rate_terms(
            codec.CodecConfig(), roi, rates, torch.ones(C, device=dev),
            torch.full((C,), 10.0, device=dev))
        branches = {"k=1": [1] * C, "k=2": [2] * C, "k=4": [4] * C,
                    "mixed": [(1, 2, 4)[i % 3] for i in range(C)]}
        for name, ks in branches.items():
            kcam = torch.tensor(ks, dtype=torch.int32, device=dev)
            got = tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam)
            torch.cuda.synchronize()
            want = tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst["tx_codec"] = max(worst["tx_codec"], err)
            print(f"tx_codec vs plain C={C} {name} {tuple(frames.shape)}: "
                  f"max |diff| {err}")
            if not err <= 1e-6:
                raise AssertionError("tx_codec differs from its plain "
                                     "version by more than 1e-6")

    # -- 4. the episode, four methods, card vs the port's CPU run -------
    light_h, server_h = load_detector("light", "cpu"), load_detector(
        "server", "cpu")

    def make_system(C: int, device) -> DeepStreamSystem:
        s = DeepStreamSystem(SystemConfig(scene=SceneConfig(
            seed=7, num_cameras=C)), light_h, server_h, device=device)
        s.mlp = init_utility_mlp(prng.PRNGKey(0, device=s.device))
        s.tau_wl, s.tau_wh = 10.0, 50.0
        s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(
            np.float32)
        return s

    trace = bandwidth_trace("medium", T_SLOTS, seed=3)
    gpu_sys, cpu_sys = make_system(5, dev), make_system(5, "cpu")
    log_keys = ("utility", "bytes", "alloc_kbps", "extra", "area")
    launches = {"edge_motion": 0, "tx_codec": 0}
    for method in METHODS:
        scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
        em_ops.LAUNCHES = 0
        tx_ops.LAUNCHES = 0
        logs = gpu_sys.run_episode(scene, trace, method)
        n_em, n_tx = em_ops.LAUNCHES, tx_ops.LAUNCHES
        launches["edge_motion"] += n_em
        launches["tx_codec"] += n_tx
        for k in log_keys + ("mean_f1",):
            if not np.all(np.isfinite(logs[k])):
                raise AssertionError(f"{method}: non-finite {k}")
        if not np.all((logs["mean_f1"] >= 0.0) & (logs["mean_f1"] <= 1.0)):
            raise AssertionError(f"{method}: F1 outside [0, 1]")
        if n_tx == 0 or (method in ("deepstream", "reducto") and n_em == 0):
            raise AssertionError(f"{method}: kernel not launched on the "
                                 f"main path (edge_motion {n_em}, "
                                 f"tx_codec {n_tx})")
        cpu_logs = cpu_sys.run_episode(
            DeviceScene(cpu_sys.cfg.scene, device="cpu"), trace, method)
        diffs = max_log_diff(cpu_logs, logs, log_keys, 1e-5)
        print(f"episode {method} C=5 T={T_SLOTS}: launches edge_motion "
              f"{n_em} tx_codec {n_tx}; mean F1 "
              f"{float(np.mean(logs['mean_f1'])):.4f}; card vs CPU max diff "
              + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))

    # -- 5. times --------------------------------------------------------
    for C in (5, 16):
        s = gpu_sys if C == 5 else make_system(C, dev)
        tr = trace * C / 5
        for method in METHODS:
            s.run_episode(DeviceScene(s.cfg.scene, device=dev), tr, method)
            scene = DeviceScene(s.cfg.scene, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_episode(scene, tr, method)
            ms = (time.perf_counter() - t0) * 1e3 / T_SLOTS
            print(f"ms/slot {method} C={C} T={T_SLOTS}: {ms:.3f} {tag}")

    scene = DeviceScene(SceneConfig(seed=7, num_cameras=5), device=dev)
    frames = segments_device(scene.cfg, scene.params, scene.key, 3,
                             gt_pad=scene.G)[0].contiguous()
    C, N, H, W = frames.shape
    keys = prng.fold_in(prng.PRNGKey(11, device=dev),
                        torch.arange(C, device=dev))
    noise = prng.normal(keys, frames.shape[1:])
    levels = torch.full((C,), 64.0, device=dev)
    sigma = torch.full((C,), 0.01, device=dev)
    kcam = torch.tensor([1, 2, 4, 1, 2], dtype=torch.int32, device=dev)
    px = C * N * H * W
    records = []
    for name, kname, fn, plain, nbytes, ops, src, tpu in (
            ("edge_motion", "edge_motion_kernel",
             lambda: em_ops.edge_motion_cuda(frames, block_size=bs,
                                             edge_thresh=thr),
             lambda: em_ref.segment_motion_ref(frames, block_size=bs,
                                               edge_thresh=thr),
             4 * (px + C * (N - 1) * (H // bs) * (W // bs)),
             # two 3x3 Sobel |g|^2 (14 flops each), compare, XOR, sum
             C * (N - 1) * H * W * 33,
             "src/repro_torch/csrc/edge_motion.cu",
             "src/repro/kernels/edge_motion/edge_motion.py:48"),
            ("tx_codec", "tx_codec_kernel",
             lambda: tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam),
             lambda: tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam),
             4 * 3 * px,
             # pool sum (up to 15 adds) + divide, quantise (3), fma, clip (2)
             px * 8,
             "src/repro_torch/csrc/tx_codec.cu",
             "src/repro/kernels/tx_codec/tx_codec.py:78")):
        # ms: kernel time on the card; stream_ms: back-to-back calls timed
        # with CUDA events, which includes the host's launch gaps
        ms = device_ms(torch, fn, 100, kname)
        plain_ms = device_ms(torch, plain, 10)
        stream_ms = cuda_ms(torch, fn)
        plain_stream_ms = cuda_ms(torch, plain, iters=20)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        print(f"kernel {name} {tuple(frames.shape)}: {ms * 1e3:.2f} us on "
              f"the card ({stream_ms * 1e3:.2f} us per call back to back), "
              f"plain {plain_ms * 1e3:.2f} us ({plain_stream_ms * 1e3:.2f} "
              f"us), bound {bound_ms * 1e3:.3f} us "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) {tag}")
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "shape": list(frames.shape), "launches": launches[name],
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "stream_ms": stream_ms, "plain_stream_ms": plain_stream_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gpu_sys.run_episode(scene, trace, "deepstream")
            wall = time.perf_counter() - t0
        from torch.autograd import DeviceType
        dev_us = device_us(prof)
        n_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation)
        print(f"profile deepstream C=5 T={T_SLOTS}: wall {wall * 1e3:.1f} ms, "
              f"{n_kernels} kernels on the card taking {dev_us / 1e3:.1f} ms "
              f"({100 * dev_us / 1e3 / (wall * 1e3):.1f}% busy) {tag}")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=15))
        # where the episode still waits on the card (host syncs per site)
        import collections
        import warnings
        for method in METHODS:
            scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                gpu_sys.run_episode(scene, trace, method)
            torch.cuda.set_sync_debug_mode("default")
            sites = collections.Counter(
                f"{Path(w.filename).name}:{w.lineno}" for w in caught)
            print(f"host syncs {method} C=5 T={T_SLOTS}: {sum(sites.values())}"
                  f" {dict(sites.most_common())}")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
