#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  ``python3 chip_smoke.py``  (``--profile`` adds a torch.profiler
pass over one episode and host-sync counts of both runners).  It needs no
JAX.  In order it prints:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build time (nvcc for sm_90a, every source at once);
  3. each hand-written kernel against its plain PyTorch version on the card
     at the main path's shapes: edge_motion exact, tx_codec <= 1e-6 in
     bitrate and CRF mode, knapsack_dp values bitwise and choices equal
     (plus the host solve against the exhaustive oracle);
  4. the four-method whole-trace episode (5 cameras, 96x160, 10 frames per
     slot, T=8): finite logs, F1 in [0, 1], every kernel of the path
     launched, the card's logs equal to the port's own CPU run (<= 1e-5);
  5. the pipelined ``run()`` loop, four methods, same cells: the same
     checks, knapsack_dp launched once per slot for deepstream and jcab,
     logs equal to the card's episode and to the CPU ``run()`` (<= 1e-5);
  6. ``alloc="host"`` against device control, and the sequential runner
     against the pipelined one, on the card;
  7. ms/slot of both runners per method at C=5 and C=16 (median of 3 after
     a warm-up, with min and max, the two runners timed in turns), and
     each kernel's time beside its plain version's and its bound, tagged
     with the card and power limit;
  8. the wall time, one JSON line of kernel records, then the device line
     (last).

Each path runs with every kernel's launch counter set to 0 just before it
and read just after.  Any mismatch ends the run with a non-zero exit code;
no phase's failure is caught.  Without a CUDA device it exits non-zero
before printing a result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
METHODS = ("deepstream", "jcab", "reducto", "static")
T_SLOTS = 8
T_CPU = 4                    # slots of the CPU runs the card is held to
LOG_KEYS = ("utility", "bytes", "alloc_kbps", "extra", "area")
DP_COSTS = (1, 2, 4, 8, 16, 20)   # the default codec's grid (d = 50 Kbps)


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


def max_log_diff(ref: dict, got: dict, keys, tol: float,
                 what: str = "card vs CPU") -> dict:
    """Per-key max |got - ref|; raises past tol * max(1, |ref|max) (the
    JAX package's harness rule)."""
    import numpy as np
    out = {}
    for k in keys:
        r, g = np.asarray(ref[k], float), np.asarray(got[k], float)
        d = float(np.max(np.abs(r - g))) if r.size else 0.0
        scale = max(1.0, float(np.max(np.abs(r))) if r.size else 1.0)
        if not d <= tol * scale:
            raise AssertionError(f"key {k}: {what} diff {d} > {tol * scale}")
        out[k] = d
    return out


def check_close(ref: dict, got: dict, atol: dict, rtol: dict, what: str
                ) -> dict:
    """Per-key max |got - ref| against absolute and relative tolerances
    (the JAX package's cross-mode test tolerances)."""
    import numpy as np
    out = {}
    for k in sorted(set(atol) | set(rtol)):
        r, g = np.asarray(ref[k], float), np.asarray(got[k], float)
        d = np.abs(g - r)
        lim = atol.get(k, 0.0) + rtol.get(k, 0.0) * np.abs(r)
        if not np.all(d <= lim):
            raise AssertionError(f"{what} key {k}: diff {d.max()} beyond "
                                 f"atol {atol.get(k, 0.0)} rtol "
                                 f"{rtol.get(k, 0.0)}")
        out[k] = float(d.max()) if d.size else 0.0
    return out


def check_logs(logs: dict, what: str) -> None:
    import numpy as np
    for k in LOG_KEYS + ("mean_f1",):
        if not np.all(np.isfinite(logs[k])):
            raise AssertionError(f"{what}: non-finite {k}")
    if not np.all((logs["mean_f1"] >= 0.0) & (logs["mean_f1"] <= 1.0)):
        raise AssertionError(f"{what}: F1 outside [0, 1]")


def slot_ms(torch, run, T: int) -> float:
    """ms/slot of one run on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / T


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one deepstream episode and count "
                         "host syncs of both runners")
    args = ap.parse_args(argv)
    t_begin = time.perf_counter()

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
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.knapsack_dp import ref as dp_ref
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    from repro_torch.models.detector import load_detector

    counters = {"edge_motion": em_ops, "tx_codec": tx_ops,
                "knapsack_dp": dp_ops}

    def reset_counts() -> None:
        for mod in counters.values():
            mod.LAUNCHES = 0

    def read_counts() -> dict:
        return {k: mod.LAUNCHES for k, mod in counters.items()}

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
    worst = {"edge_motion": 0.0, "tx_codec": 0.0, "knapsack_dp": 0.0}
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
        # CRF mode: the fleet encode through the kernel against the
        # per-camera plain CRF encode (every blur branch, then select)
        res = torch.tensor([1.0, 0.75, 0.5, 0.74], device=dev)[
            torch.arange(C, device=dev) % 4]
        roi_crf = torch.linspace(2000.0, 96.0 * 160.0, C, device=dev)
        for blur in (True, False):
            got, sizes = tx_ops.encode_fleet_crf(
                codec.CodecConfig(), frames, roi_crf, keys, res, blur=blur)
            torch.cuda.synchronize()
            err = 0.0
            for c in range(C):
                want, want_size = codec.encode_segment_crf(
                    codec.CodecConfig(), frames[c], roi_crf[c], keys[c],
                    res[c] if blur else None)
                err = max(err, float((got[c] - want).abs().max()))
                if blur and float(sizes[c]) != float(want_size):
                    raise AssertionError("CRF sizes differ")
            worst["tx_codec"] = max(worst["tx_codec"], err)
            print(f"tx_codec CRF vs plain C={C} blur={blur}: max |diff| "
                  f"{err}")
            if not err <= 1e-6:
                raise AssertionError("tx_codec CRF differs from its plain "
                                     "version by more than 1e-6")

    costs_dev = torch.tensor(DP_COSTS, dtype=torch.int32, device=dev)
    dp_cases = []
    for I, W, kind in ((5, 127, "uniform"), (16, 127, "uniform"),
                       (32, 200, "uniform"), (5, 127, "dead"),
                       (16, 127, "dead"), (5, 127, "ties"),
                       (16, 127, "ties")):
        rng = np.random.default_rng(I * 1000 + W)
        util = rng.uniform(0, 1, (I, 6)).astype(np.float32)
        if kind == "dead":      # dead cameras: cheapest option at 0 only
            dead = rng.choice(I, size=I // 2, replace=False)
            util[dead] = -1e9
            util[dead, 0] = 0.0
        elif kind == "ties":    # coarse values: equal candidates everywhere
            util = (np.round(util * 4) / 4).astype(np.float32)
            util[:, 1] = util[:, 0]
        dp_cases.append((I, W, kind, util))
    for I, W, kind, util in dp_cases:
        u = torch.from_numpy(util).to(dev)
        vals, choices = dp_ops.knapsack_dp_cuda(u, costs_dev, W)
        torch.cuda.synchronize()
        want_v, want_c = dp_ref.knapsack_dp_ref(u, costs_dev, W)
        torch.cuda.synchronize()
        err = float((vals - want_v).abs().max())
        bad = int((choices != want_c).sum())
        worst["knapsack_dp"] = max(worst["knapsack_dp"], err)
        print(f"knapsack_dp vs plain ({I}, 6, {W + 1}) {kind}: max |diff| "
              f"values {err}, choices differing {bad}")
        if not (torch.equal(vals, want_v) and bad == 0):
            raise AssertionError("knapsack_dp differs from its plain version")
    util5 = dp_cases[0][3]
    picks, total = dp_ops.solve(util5, np.asarray(DP_COSTS, np.int32), 127,
                                device=dev)
    o_picks, o_total = dp_ref.exhaustive_oracle(
        util5, np.asarray(DP_COSTS), 127)
    print(f"knapsack_dp host solve (5, 6, 128) vs exhaustive oracle: picks "
          f"{picks.tolist()} vs {o_picks.tolist()}, total {total} vs "
          f"{o_total}")
    if not (np.array_equal(picks, o_picks) and abs(total - o_total) <= 1e-5):
        raise AssertionError("host solve differs from the exhaustive oracle")

    # -- 4. the episode, four methods, card vs the port's CPU run -------
    light_h, server_h = load_detector("light", "cpu"), load_detector(
        "server", "cpu")

    def make_system(C: int, device, **kw) -> DeepStreamSystem:
        s = DeepStreamSystem(SystemConfig(scene=SceneConfig(
            seed=7, num_cameras=C), **kw), light_h, server_h, device=device)
        s.mlp = init_utility_mlp(prng.PRNGKey(0, device=s.device))
        s.tau_wl, s.tau_wh = 10.0, 50.0
        s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(
            np.float32)
        return s

    def needs(method: str) -> tuple:
        """The kernels a method's main path launches."""
        return (("edge_motion",) if method in ("deepstream", "reducto")
                else ()) + ("tx_codec",) + (
            ("knapsack_dp",) if method in ("deepstream", "jcab") else ())

    trace = bandwidth_trace("medium", T_SLOTS, seed=3)
    gpu_sys, cpu_sys = make_system(5, dev), make_system(5, "cpu")
    launches_episode = dict.fromkeys(counters, 0)
    episode_logs = {}
    for method in METHODS:
        scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
        reset_counts()
        logs = gpu_sys.run_episode(scene, trace, method)
        n = read_counts()
        episode_logs[method] = logs
        for k in counters:
            launches_episode[k] += n[k]
        check_logs(logs, f"episode {method}")
        if any(n[k] == 0 for k in needs(method)):
            raise AssertionError(f"episode {method}: kernel not launched on "
                                 f"the main path {n}")
        cpu_logs = cpu_sys.run_episode(
            DeviceScene(cpu_sys.cfg.scene, device="cpu"), trace, method)
        diffs = max_log_diff(cpu_logs, logs, LOG_KEYS, 1e-5)
        print(f"episode {method} C=5 T={T_SLOTS}: launches "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; mean F1 {float(np.mean(logs['mean_f1'])):.4f}; card vs "
              "CPU max diff "
              + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))

    # -- 5. run(), pipelined, four methods -------------------------------
    launches_run = dict.fromkeys(counters, 0)
    run_logs = {}
    for method in METHODS:
        scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
        reset_counts()
        logs = gpu_sys.run(scene, trace, method)
        n = read_counts()
        run_logs[method] = logs
        for k in counters:
            launches_run[k] += n[k]
        check_logs(logs, f"run {method}")
        if any(n[k] == 0 for k in needs(method)):
            raise AssertionError(f"run {method}: kernel not launched on the "
                                 f"main path {n}")
        want_dp = T_SLOTS if "knapsack_dp" in needs(method) else 0
        if n["knapsack_dp"] != want_dp:
            raise AssertionError(f"run {method}: knapsack_dp launched "
                                 f"{n['knapsack_dp']} times, not {want_dp}")
        d_ep = max_log_diff(episode_logs[method], logs, LOG_KEYS, 1e-5,
                            "run vs episode")
        cpu_logs = cpu_sys.run(DeviceScene(cpu_sys.cfg.scene, device="cpu"),
                               trace[:T_CPU], method)
        head = {k: v[:T_CPU] for k, v in logs.items()}
        d_cpu = max_log_diff(cpu_logs, head, LOG_KEYS, 1e-5)
        print(f"run {method} C=5 T={T_SLOTS}: launches "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; mean F1 {float(np.mean(logs['mean_f1'])):.4f}; vs the "
              "card's episode max diff "
              + " ".join(f"{k}={v:.3g}" for k, v in d_ep.items())
              + f"; vs CPU run() (T={T_CPU}) "
              + " ".join(f"{k}={v:.3g}" for k, v in d_cpu.items()))

    # -- 6. host control and the sequential runner on the card ----------
    host_sys = make_system(5, dev, pipeline=False, alloc="host")
    seq_sys = make_system(5, dev, batched=False)
    tr4 = trace[:4]
    tr2 = trace[:2]
    for label, system, methods, tr, ref_tol in (
            ("alloc=host", host_sys, ("deepstream", "jcab"), tr4,
             (dict(utility=1e-5, bytes=1e-3, alloc_kbps=1e-3, extra=1e-3,
                   area=1e-4), {})),
            ("sequential", seq_sys, ("deepstream", "reducto"), tr2,
             (dict(utility=1e-3), dict(bytes=1e-6, alloc_kbps=1e-6)))):
        n_total = dict.fromkeys(counters, 0)
        for method in methods:
            reset_counts()
            logs = system.run(DeviceScene(system.cfg.scene, device=dev), tr,
                              method)
            n = read_counts()
            for k in counters:
                n_total[k] += n[k]
            check_logs(logs, f"{label} {method}")
            ref = gpu_sys.run(DeviceScene(gpu_sys.cfg.scene, device=dev), tr,
                              method)
            d = check_close(ref, logs, *ref_tol, f"{label} {method}")
            print(f"{label} {method} C=5 T={len(tr)}: launches "
                  + " ".join(f"{k} {v}" for k, v in n.items())
                  + "; vs pipelined device control max diff "
                  + " ".join(f"{k}={v:.3g}" for k, v in d.items()))
        if n_total["knapsack_dp"] == 0 or n_total["edge_motion"] == 0:
            raise AssertionError(f"{label}: B1 or B3 not launched {n_total}")

    # -- 7. times --------------------------------------------------------
    for C in (5, 16):
        s = gpu_sys if C == 5 else make_system(C, dev)
        tr = trace * C / 5
        for method in METHODS:
            # both runners in turns (episode, run, run, episode, ...) after
            # one warm-up each, so host drift hits them alike
            runners = ("run_episode", "run")
            ms = {r: [] for r in runners}
            for rnd in range(4):
                for r in (runners if rnd % 2 == 0 else runners[::-1]):
                    scene = DeviceScene(s.cfg.scene, device=dev)
                    t_ms = slot_ms(torch, lambda: getattr(s, r)(
                        scene, tr, method), T_SLOTS)
                    if rnd > 0:
                        ms[r].append(t_ms)
            for r in runners:
                print(f"ms/slot {r} {method} C={C} T={T_SLOTS}: median "
                      f"{statistics.median(ms[r]):.3f} (min {min(ms[r]):.3f}"
                      f", max {max(ms[r]):.3f}, 3 runs) {tag}")

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
    dp_util = torch.from_numpy(dp_cases[0][3]).to(dev)
    dpI, dpJ, dpW = 5, len(DP_COSTS), 127
    records = []
    for name, kname, fn, plain, shape, nbytes, ops, src, tpu in (
            ("edge_motion", "edge_motion_kernel",
             lambda: em_ops.edge_motion_cuda(frames, block_size=bs,
                                             edge_thresh=thr),
             lambda: em_ref.segment_motion_ref(frames, block_size=bs,
                                               edge_thresh=thr),
             list(frames.shape),
             4 * (px + C * (N - 1) * (H // bs) * (W // bs)),
             # two 3x3 Sobel |g|^2 (14 flops each), compare, XOR, sum
             C * (N - 1) * H * W * 33,
             "src/repro_torch/csrc/edge_motion.cu",
             "src/repro/kernels/edge_motion/edge_motion.py:48"),
            ("tx_codec", "tx_codec_kernel",
             lambda: tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam),
             lambda: tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam),
             list(frames.shape),
             4 * 3 * px,
             # pool sum (up to 15 adds) + divide, quantise (3), fma, clip (2)
             px * 8,
             "src/repro_torch/csrc/tx_codec.cu",
             "src/repro/kernels/tx_codec/tx_codec.py:78"),
            ("knapsack_dp", "knapsack_dp_kernel",
             lambda: dp_ops.knapsack_dp_cuda(dp_util, costs_dev, dpW),
             lambda: dp_ref.knapsack_dp_ref(dp_util, costs_dev, dpW),
             [dpI, dpJ, dpW + 1],
             # util and costs read, values and choices written, once each
             4 * (dpI * dpJ + dpJ + (dpW + 1) + dpI * (dpW + 1)),
             # per (i, w, j): add, compare, select
             dpI * dpJ * (dpW + 1) * 3,
             "src/repro_torch/csrc/knapsack_dp.cu",
             "src/repro/kernels/knapsack_dp/knapsack_dp.py:54")):
        # ms: kernel time on the card; stream_ms: back-to-back calls timed
        # with CUDA events, which includes the host's launch gaps
        ms = device_ms(torch, fn, 100, kname)
        plain_ms = device_ms(torch, plain, 10)
        stream_ms = cuda_ms(torch, fn)
        plain_stream_ms = cuda_ms(torch, plain, iters=20)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        print(f"kernel {name} {tuple(shape)}: {ms * 1e3:.2f} us on "
              f"the card ({stream_ms * 1e3:.2f} us per call back to back), "
              f"plain {plain_ms * 1e3:.2f} us ({plain_stream_ms * 1e3:.2f} "
              f"us), bound {bound_ms * 1e3:.4f} us "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) {tag}")
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "shape": shape, "launches": launches_run[name],
            "launches_episode": launches_episode[name],
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
        # where each runner still waits on the card (host syncs per site)
        import collections
        import warnings
        for runner in ("run_episode", "run"):
            for method in METHODS:
                scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
                torch.cuda.set_sync_debug_mode("warn")
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    getattr(gpu_sys, runner)(scene, trace, method)
                torch.cuda.set_sync_debug_mode("default")
                sites = collections.Counter(
                    f"{Path(w.filename).name}:{w.lineno}" for w in caught)
                print(f"host syncs {runner} {method} C=5 T={T_SLOTS}: "
                      f"{sum(sites.values())} {dict(sites.most_common())}")

    print(f"chip_smoke wall time: {time.perf_counter() - t_begin:.1f} s "
          f"{tag}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
