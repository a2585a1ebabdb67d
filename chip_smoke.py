#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  ``python3 chip_smoke.py``  (``--profile`` adds a torch.profiler
pass over one graph-replayed and one eager episode and host-sync counts
per site of both runners).  It needs no
JAX.  In order it prints:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build time (nvcc for sm_90a, every source at once) and
     each kernel's registers, stack frame and spills (ptxas);
  3. each hand-written kernel against its plain PyTorch version on the card
     at the main path's shapes: edge_motion bitwise (also with W % 4 != 0,
     bs = 2 and 6, M = 2, an unaligned base and frames past one block's
     shared memory, each under its launch plan, whole-row segments and one
     pair per chunk), tx_codec bitwise in
     bitrate and CRF mode (also at frame sizes that are multiples of
     neither 4 nor the pool factor, every pool factor), knapsack_dp values
     bitwise and choices equal, and its fused solve's picks and total
     equal to the plain backtrack's (W = 20000 included; the host solve
     against the CPU's and the exhaustive oracle), flash_decode in bf16
     and f32 at granite-8b's
     decode shape (B=4, S=2048, 32/8 heads, hd=128) and at the GQA groups
     and head sizes of the other configs (G = 1, 7, 8, 16; hd 64, 112,
     128; the vlm's cross decode at S = 4096), valid lengths 0 to S and
     one on a range boundary, with and
     without the fresh token; cc_label bitwise (labels, and the boxes
     built on them) on the scenes' motion masks at C = 5 and 16, empty
     and full masks, serpentines at 12 x 20 and 68 x 120 and random masks
     at 68 x 120; tx_codec bitwise at the profiling sweep's shape
     (30, 10, 96, 160): a profiled slot's 5 cameras x 3 resolutions x
     masked/full, at each of the 6 bitrates;
  3b. the offline profile at full width (``SystemConfig(eval_frames=5)``,
     C = 5, 96 x 160, 10 frames, 6 bitrates, 3 resolutions) on
     ``MultiCameraScene(SceneConfig(seed=42))``, 8 slots and 700 fit
     steps: its artifacts (mlp_mse, thresholds, samples, the jcab table),
     the sweep's ms per slot (and one slot's parts timed alone) and the
     fit's ms per step, launches B1 8,
     cc_label 8, B2 48, B3 0, and exactly 1 host sync in ``utility.fit``
     (the final loss, ``set_sync_debug_mode("warn")``); then 2 slots and
     120 steps on the card and on the CPU: features, targets (the masked
     F1 table) and the jcab table to <= 1e-5, thresholds equal, fitted
     parameters to <= 1e-5.  Every later phase runs on these artifacts
     (the thresholds scaled to C cameras);
  3c. ``fleet_control_scan`` over 16 slots of deepstream control: equal
     to 16 ``fleet_control_step`` calls bitwise, no host sync, knapsack_dp
     launched 16 times;
  3d. Fig. 3: the pipelined ``run()`` of deepstream, its no-elastic
     ablation, jcab, reducto and static on
     ``MultiCameraScene(SceneConfig(seed=77))`` over the low, medium and
     high ``bandwidth_trace(kind, 16, seed=3)``, uniform and with the
     paper's weights: mean utility per cell and deepstream's gain over the
     best baseline (not a gate); finite logs, knapsack_dp once per slot
     where the DP runs, and the medium trace's first 4 slots equal to the
     CPU ``run()`` on the same artifacts (<= 1e-5);
  4. the whole-trace episode as the JAX package runs it in production
     (pipelined, bucketed), its slot step replayed as CUDA graphs, for
     the four methods and deepstream_no_elastic at C=5 and C=16, T=8
     (bucket 8) and T=11 (bucket 16): the first run's capture goes through
     the wrapper of each kernel of its path; a second run captures
     nothing, calls no wrapper and runs under
     ``torch.cuda.set_sync_debug_mode("error")`` up to its harvest (its
     kernels as the card records them are counted in phase 9); the logs
     equal the eager reference body's on the card bitwise and the port's
     CPU run's to <= 1e-5; then a camera_churn run (no capture, the same
     checks) and two windows chained through the carry against one run;
  5. the pipelined ``run()`` loop, four methods, C=5, T=8: the same
     checks, knapsack_dp launched once per slot for deepstream and jcab
     and edge_motion 16 times in all, logs equal to the card's episode and
     to the CPU ``run()`` (<= 1e-5);
  6. ``alloc="host"`` against device control, and the sequential runner
     against the pipelined one, on the card (no solve on the card takes
     the plain backtrack);
  6b. crash-safe fleet serving (``serve.stream``) at full width:
     ``SystemConfig()`` defaults in episode mode, the capacity pinned at
     8000 Kbps, ``make_soak_stream(64, num_cams=5)`` in windows of 8: each
     method's windowed logs against one ``run_episode`` over the stream
     (<= 1e-5, bitwise expected) and deepstream's first 16 slots against
     the CPU stream; each kernel of the path against its plain version on
     the inputs the path gives it (one eager window per method, every
     dispatcher repeated on CPU copies); kill-and-resume (deepstream: a
     crash before window 3; reducto: the same with the newest generation
     bit-flipped, so that the restore falls back one generation) equal to
     the uninterrupted stream with no graph captured after the restore;
     the ladder down to the slot loop and back, equal; ``EpisodeSupervisor`` degrading to the chunked rung,
     card = CPU; the checked lane bitwise equal to the unchecked lane
     (episode and pipelined), no host sync before the episode's harvest
     under ``set_sync_debug_mode("error")``, a NaN slot raising at the
     harvest; the launcher (``--fleet-stream``) run twice, the second
     restoring; and the ``stream C= method=`` lines: window turnaround
     p50/p99, slots/s, the checkpoint's snapshot, async write and restore
     ms, and host syncs per window (harvest, checkpoint) at C=5 and 16;
  7. the LM serving tier: the f32 smoke engine run on the card against
     the CPU (tokens identical, logits <= 1e-4), then ``ServeEngine`` over
     granite-8b at its published width and depth with seeded random bf16
     weights (6 requests on 4 slots, max_seq 2048, 16 new tokens each):
     every request drains, flash_decode runs once per layer and decode
     call and never in prefill, one request's last decode agrees with a
     prefill of its tokens and the kernel route with the plain one (both
     within 5e-2 of max |logit|); prefill and decode ms, tokens/s, peak
     memory and one profiled decode;
  8. ms/slot of the graph-replayed episode (pipelined and reference
     body), the eager episode and ``run()`` per method at C=5 and C=16
     (CUDA events around each whole run, the four in turns, median, min
     and max of 5 runs after a warm-up), and each kernel's time beside
     its plain version's and its bound (and, for flash_decode,
     scaled_dot_product_attention's as the library yardstick), tagged with
     the card and power limit; the kernel times are taken first, right
     after the build, in two passes (``kernel_time_records``): the
     one-kernel windows of all five kernels, then the plain versions' and
     the library calls' windows, so that no profiled phase and no plain
     version's window thins their CUPTI records: each one-kernel window
     must record all 100 of its launches (one that does not is taken
     again, and printed), and one opened after any other profiler session
     of the run raises:
     edge_motion at the ROIDet, reducto and C = 16 shapes and one block's
     chain; tx_codec at (5, 10, 96, 160) and at the sweep's (30, 10, 96,
     160); knapsack_dp's fused solve at I = 5, 16 and 1 with its kernels
     per solve (one), and the sweep alone; cc_label at the C = 5 and 16
     scene masks and at 68 x 120; and ``run()`` of deepstream on a host
     scene beside the same run on a ``DeviceScene`` (in turns);
  9. each replayed episode of phase 4 once more under the profiler: its
     kernels as the card recorded them (CUPTI kernel records counted by
     name; a replay runs the kernels without their wrappers) must be T per
     kernel of the method's path and none of the others, with no wrapper
     call; the C=5, T=8 counts go into the kernel records; then one
     8-slot window of the stream per method, counted the same way;
 10. training (no hand-written kernel on its path: every launch counter
     stays 0 in the trainers): (a) the light detector trained on the
     card and on the port's CPU (``train_detector``, seed 0, 8 steps at
     batch 4, cuDNN TF32 off): each step's loss within 1e-5 relative, the
     weights within 1e-5 of max |w| a leaf; (b) the server detector at
     the JAX harness's settings (600 steps, batch 12): ms/step (CUDA
     events), the numpy scene's share, 0 host syncs in the loop
     (``set_sync_debug_mode("warn")`` from the first batch on), the final
     loss beside the committed checkpoint's, then the C=5 deepstream
     episode (8 slots, graph-replayed) with it: mean F1 per camera no
     more than 0.05 below the committed weights' run, its kernels counted
     on the card; (c) granite-8b at its published width with 8 of its 36
     layers (seeded random bf16 weights, float32 moments, remat minimal,
     2 microbatches, 4 rows of 4096 tokens): the loss falls over 3 steps
     on a fixed batch, the microbatched step's loss within 1e-2 of the
     single step's (one forward of all rows), then 5 steps on the
     loader's batches after a warm-up: median ms/step (CUDA events),
     tokens/s, MFU both ways (6 N + 12 L H hd S FLOPs a token, and the
     analytic roofline's model_flops, over H100_SXM's 989 TFLOP/s),
     peak memory, and one profiled step's kernels and busy share; (d)
     ``repro_torch.launch.train --smoke`` for 4 steps, then again with
     ``--resume``: the second run prints ``resumed from ... at step 4``;
 11. the other LM families and the int8 KV cache at their published
     widths with seeded random bf16 weights: ``ServeEngine`` over
     olmoe-1b-7b (16 layers), zamba2-7b (81), xlstm-125m (12), qwen1.5-4b
     (40, int8 cache) and llama-3.2-vision-90b (2 of its 20 superblocks,
     int8 cache, 4096 image tokens; also at the LM level with seeded
     image embeddings), 4 requests of 256/192 tokens on 4 slots, 8 new
     tokens each; seamless-m4t-large-v2 (24 + 24 layers) at the LM level
     (the engine refuses the audio family): each drains, flash_decode runs
     once per attention layer (self and cross) and decode call and never
     in prefill, decode = teacher forcing and the kernel route = the
     plain one within 5e-2 of max |logit|; prefill and decode ms, tokens/s,
     host syncs per decode call, peak memory.  Then training at full
     width: xlstm-125m (12 layers) and olmoe-1b-7b (4 of 16 layers): the
     loss falls over 3 steps, ms/step, tokens/s, MFU, peak memory.  Every
     cut depth is printed with its reason;
 12. the static audit, the dry run, the quickstart and the roofline (no
     profiler): the host-sync lint over ``src/repro_torch`` (0 findings);
     the graph audit (``repro_torch.analysis.graph_audit``) on the card:
     every registered program run once under ``NoHostReads``, 12 episode
     programs, two harvests each, the same key ops at C=5 and 9; every
     graph key phase 4 captured at C=5 is an entry of the audit's
     registry (``repro_torch.analysis.programs``) with its 4 graphs, and
     ``slot_camera_keys`` runs the same aten ops at C=5 and 16; the dry
     run (``repro_torch.launch.dryrun``) beside each ``reduced`` line, the
     weights and AdamW state phases 10 and 11 allocated at each cut depth
     equal to its bytes exactly; ``examples/quickstart_torch.py`` on the
     card (one slot: B1, B2, B3 and cc_label launched); the analytic
     roofline's one-card terms (``H100_SXM``) beside granite-8b's measured
     train step and decode;
 13. the wall time, one JSON line of kernel records, then the device line
     (last).

Phase 8's kernel times come first, and the script enforces it: a
one-kernel profiler window opened after any other profiler session of the
run has lost records (23 to 99 of 100 launches on an H100, even in a
fresh process started after the profiled work), so ``profile_window``
raises if one follows other profiled work.  Every other phase may run in
any order.

Each path runs with every kernel's launch counter set to 0 just before it
and read just after; each kernel record carries its launches on the main
path (``run()``), in the replayed episodes, in the profile, in one
window of the stream per method, in the trainers (0), in the episode
with the card-trained server detector and in the families phase.  Any
mismatch ends the run with a non-zero exit code; no phase's failure is
caught.  Without a CUDA device it exits non-zero before printing a
result.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's HBM rate and dense bf16 peak come from
# repro_torch.common.config.H100_SXM; HWConfig has no float32 rate
F32_FLOPS_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
METHODS = ("deepstream", "jcab", "reducto", "static")
EP_METHODS = METHODS + ("deepstream_no_elastic",)
T_SLOTS = 8
T_CPU = 4                    # slots of the CPU runs the card is held to
TIMED_ROUNDS = 5             # timed runs per runner, after a warm-up
LOG_KEYS = ("utility", "bytes", "alloc_kbps", "extra", "area")
DP_COSTS = (1, 2, 4, 8, 16, 20)   # the default codec's grid (d = 50 Kbps)
# what a phase measured or allocated that phase 12 reads: the bytes of the
# weights and AdamW state of each cut model ("allocated", by (arch, kind,
# layers)) and granite-8b's train step and decode ms ("measured")
RECORDED = {"allocated": {}, "measured": {}}


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


# which windows a pass of ``kernel_time_records`` takes: "kernel" (the
# one-kernel windows and the kernels' back-to-back times) or "plain" (the
# plain versions' and the library calls' windows); a number the pass does
# not take reads NaN until the two passes are merged
PART = None
NAN = float("nan")
# the share of its launches a one-kernel window must record, or it is
# taken again: all of them (each runs before any other profiled work)
MIN_RECORDED = 1.0
# the profiler sessions this process opened other than one-kernel
# windows.  A one-kernel window opened after profiled work loses kernel
# records (23 to 99 of 100 on an H100, even in a fresh process started
# after it), so every one-kernel window comes first in the run:
# ``profile_window`` raises if one opens after any of these
PROFILED = []


def timed(part: str, fn):
    """``fn()``, or NaN when this pass does not take ``part``."""
    return fn() if PART in (None, part) else NAN


def profiler(torch, what):
    """A torch.profiler session over the host and the card, noted in
    PROFILED as ``what`` (a one-kernel window: None, not noted)."""
    from torch.profiler import ProfilerActivity, profile
    if what is not None:
        PROFILED.append(what)
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_ms(torch, fn, iters: int, name=None) -> float:
    """Mean kernel time on the card per call of ``fn`` (launch gaps on the
    host excluded), from torch.profiler."""
    return timed("plain", lambda: device_ms_count(torch, fn, iters, name)[0])


def profile_window(torch, fn, iters: int, name=None,
                   one_kernel: bool = False) -> tuple:
    """(kernel us, kernels) the profiler recorded on the card over ``iters``
    calls of ``fn`` after one warm-up call: every kernel, or those whose
    name contains ``name``.  A ``one_kernel`` window raises if the process
    has profiled anything but one-kernel windows before it."""
    from torch.autograd import DeviceType
    if one_kernel and PROFILED:
        raise AssertionError(
            f"a one-kernel window ({name}) after other profiled work "
            f"({', '.join(sorted(set(PROFILED)))}): the kernel times must "
            "be taken before any other profiler window of the run")
    fn()
    torch.cuda.synchronize()
    with profiler(torch, None if one_kernel
                  else "the plain versions' windows") as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)    # the card's activity records arrive late
    count = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation
                and (name is None or name in e.key))
    return device_us(prof, name), count


def device_ms_count(torch, fn, iters: int, name=None, windows: int = 5):
    """``device_ms`` and the kernels per call it counted.  A window in
    which the profiler recorded no kernel time (it drops records now and
    then) is taken again, up to ``windows`` windows; then it raises."""
    for _ in range(windows):
        us, count = profile_window(torch, fn, iters, name)
        if us > 0.0:
            return us / 1e3 / iters, count / iters
        print(f"{name or 'the plain version'}: the profiler recorded no "
              f"kernel time in a window of {iters} calls; taking another")
    raise AssertionError(f"the profiler recorded no kernel time for "
                         f"{name or 'the plain version'} in {windows} "
                         "windows")


# every one-kernel window taken: (what, kernels recorded, calls)
WINDOWS = []


def one_kernel_ms(torch, fn, iters: int, name=None, what: str = "",
                  windows: int = 5):
    """Kernel time on the card per recorded kernel of ``fn``, which must
    launch one kernel per call (those whose name contains ``name``, or
    every kernel): (ms, kernels per call).  Raises if a window records
    more than one per call.  A window that records fewer than
    MIN_RECORDED of its launches (the profiler drops records now and then)
    is taken again (printed), up to ``windows`` windows; then it raises."""
    if PART == "plain":
        return NAN, NAN
    for _ in range(windows):
        us, count = profile_window(torch, fn, iters, name, one_kernel=True)
        WINDOWS.append((what or name, count, iters))
        per_call = count / iters
        if per_call > 1.0:
            raise AssertionError(f"{what or name} ran {per_call} kernels per "
                                 "call, not one")
        if per_call >= MIN_RECORDED:
            return us / 1e3 / count, per_call
        print(f"{what or name}: the profiler recorded {per_call:g} kernels "
              f"per call in a window of {iters}; taking another")
    raise AssertionError(f"{what or name} ran {per_call} kernels per call, "
                         "not one")


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


# -- the LM serving tier (slice 3) ---------------------------------------

FD_SHAPE = (4, 2048, 32, 8, 128)           # granite-8b decode: B, S, H, KV, hd
FD_VALID = (0, 1, 511, 1500, 2048)
# where the run sits; a full cache; one tile in one range (the latency of
# a single block: launch, q, one tile, no merge)
FD_TIMED = (528, 2048, 64)
SMALL_PROMPTS = (8, 8, 12, 12, 5, 8)       # tests/test_torch_serve.py
FULL_PROMPTS = (512, 512, 384, 384, 512, 256)
FULL_NEW, FULL_SLOTS, FULL_SEQ = 16, 4, 2048


def fd_inputs(torch, dev, dtype, B, S, H, KV, hd, seed=0):
    """q, k, v, k1, v1 of standard normals from numpy (seeded)."""
    import numpy as np
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(0, 1, s).astype(np.float32)).to(
                dev, dtype)
            for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, 1, KV, hd), (B, 1, KV, hd))]


# B4's parity shapes (B, S, H, KV, hd): granite-8b's decode, then the GQA
# groups and head sizes of the other configs: G = 1 at hd 128, G = 7
# (yi-34b, 56/8), G = 16 (llama3-405b, 128/8), G = 1 at hd 64
# (seamless-m4t) and at hd 112 (zamba2), G = 8 (llama-3.2-vision's and
# kimi's self-attention, 64/8), and the vlm's cross-attention decode over
# 4096 image tokens (every position valid: S is among its lengths)
FD_PARITY = (FD_SHAPE, (4, 2048, 8, 8, 128), (2, 2048, 56, 8, 128),
             (1, 2048, 128, 8, 128), (2, 2048, 16, 16, 64),
             (1, 2048, 32, 32, 112), (4, 2048, 64, 8, 128),
             (4, 4096, 64, 8, 128))


def range_boundary_len(fd_ops, B, S, KV, G, hd, elem, sms) -> int:
    """The longest valid length below S that ends exactly on the last of
    several ranges of the kernel's plan."""
    for n in range(S - 64, 63, -64):
        per, nsplit, _ = fd_ops.split_plan(n, B * KV, sms, G, hd, elem)
        if nsplit > 1 and n % (per * fd_ops.TILE) == 0:
            return n
    raise AssertionError(f"no range boundary below {S}")


def check_flash_decode(torch, dev) -> dict:
    """B4 against its plain version on the card at every FD_PARITY shape
    in bf16 and f32, at valid lengths FD_VALID, S and one that ends on a
    range boundary: ``flash_decode`` (out, m, l) and ``flash_decode_with_new``
    (against the same merge of the plain version's stats).  out to <= 1e-5
    in float32 and 2e-2 in bfloat16 (tests/test_kernels.py's rules), m to
    <= 1e-5, l to <= 1e-5 of max(1, max l) (a sum of up to S exponentials;
    the JAX harness's scaled rule).  The wrapper's shared-memory plan is
    held to the library's own.  Returns the worst |diff| of out per
    dtype."""
    from repro_torch.common.device import sm_count
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    sms = sm_count(dev)
    smem_c = fd_ops._fns()[1]
    worst = {}
    for shape in FD_PARITY:
        B, S, H, KV, hd = shape
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, k1, v1 = fd_inputs(torch, dev, dt, *shape)
            elem = q.element_size()
            for st in (1, 2, 3):
                if smem_c(int(elem == 2), hd, st) != fd_ops.smem_bytes(
                        elem, hd, st):
                    raise AssertionError("the wrapper plans with another "
                                         "shared-memory size than the kernel")
            tol = 1e-5 if dt == torch.float32 else 2e-2
            edge = range_boundary_len(fd_ops, B, S, KV, H // KV, hd, elem,
                                      sms)
            for vl in FD_VALID + (edge,) + ((S,) if S not in FD_VALID
                                            else ()):
                before = fd_ops.LAUNCHES
                out, m, l = fd_ops.flash_decode_cuda(q, k, v, vl)
                torch.cuda.synchronize()
                if fd_ops.LAUNCHES != before + 1:
                    raise AssertionError("flash_decode counted "
                                         f"{fd_ops.LAUNCHES - before} launches")
                wo, wm, wl = fd_ref.flash_decode_ref(q, k, v, kv_valid_len=vl)
                e_out = float((out.float() - wo.float()).abs().max())
                e_m = float((m - wm).abs().max())
                e_l = float((l - wl).abs().max())
                l_tol = 1e-5 * max(1.0, float(wl.abs().max()))
                got = fd_ops.flash_decode_with_new(q, k, v, k1, v1,
                                                   kv_valid_len=vl)
                want = fd_ops.merge_new(q, k1, v1, wo, wm, wl)
                e_new = float((got.float() - want.float()).abs().max())
                key = str(dt).split(".")[-1]
                worst[key] = max(worst.get(key, 0.0), e_out, e_new)
                n_pos = min(vl, S) if vl > 0 else S
                plan = fd_ops.split_plan(n_pos, B * KV, sms, H // KV, hd,
                                         elem)
                print(f"flash_decode vs plain {shape} {key} valid {vl} "
                      f"(plan {plan}): max |diff| out {e_out:.3g}, m "
                      f"{e_m:.3g}, l {e_l:.3g} (<= {l_tol:.3g}); with the "
                      f"fresh token {e_new:.3g}")
                if not (e_out <= tol and e_new <= tol and e_m <= 1e-5
                        and e_l <= l_tol):
                    raise AssertionError("flash_decode differs from its "
                                         "plain version")
    return worst


def check_tx_codec_ragged(torch, dev) -> float:
    """B2 against its plain version at frame sizes that are multiples of
    neither 4 nor any pool factor, each branch alone and mixed, in bitrate
    mode (the kernel's wrapper) and CRF mode (the fleet encode against the
    per-camera plain encode): bitwise equal.  Returns the worst |diff|."""
    from repro_torch.common import prng
    from repro_torch.core import codec
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    worst = 0.0
    for C, N, H, W in ((4, 3, 101, 157), (4, 2, 37, 45), (3, 2, 9, 13)):
        gen = torch.Generator(device=dev).manual_seed(H * W)
        frames = torch.rand((C, N, H, W), device=dev, generator=gen)
        keys = prng.fold_in(prng.PRNGKey(13, device=dev),
                            torch.arange(C, device=dev))
        noise = prng.normal(keys, frames.shape[1:])
        levels = torch.linspace(4.0, 256.0, C, device=dev)
        sigma = torch.linspace(0.001, 0.3, C, device=dev)
        for ks in ([1] * C, [2] * C, [4] * C, [8] * C,
                   [(1, 2, 4, 8)[i % 4] for i in range(C)]):
            kcam = torch.tensor(ks, dtype=torch.int32, device=dev)
            got = tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam)
            torch.cuda.synchronize()
            want = tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"tx_codec vs plain {(C, N, H, W)} k={ks}: max |diff| "
                  f"{err}")
            if not torch.equal(got, want):
                raise AssertionError("tx_codec differs from its plain "
                                     "version")
        res = torch.tensor([1.0, 0.75, 0.5, 0.25], device=dev)[
            torch.arange(C, device=dev) % 4]
        roi = torch.linspace(500.0, float(H * W), C, device=dev)
        for blur in (True, False):
            got, _ = tx_ops.encode_fleet_crf(codec.CodecConfig(), frames, roi,
                                             keys, res, blur=blur)
            torch.cuda.synchronize()
            err = 0.0
            for c in range(C):
                want, _ = codec.encode_segment_crf(
                    codec.CodecConfig(), frames[c], roi[c], keys[c],
                    res[c] if blur else None)
                err = max(err, float((got[c] - want).abs().max()))
            worst = max(worst, err)
            print(f"tx_codec CRF vs plain {(C, N, H, W)} blur={blur}: max "
                  f"|diff| {err}")
            if err != 0.0:
                raise AssertionError("tx_codec CRF differs from its plain "
                                     "version")
    return worst


# -- B1 and B3 (slice 5: redesigned) ------------------------------------

# B1 parity shapes beyond the main path's (C, M, H, W, bs): W % 4 != 0 with
# bs = 6 (blocks straddle 32-bit words), bs = 2, M = 2 (one pair), and
# more frames than fit one block, in the plan's chunks of 140 and of 744
# pairs (more frames than a block has threads)
EM_EXTRA = ((2, 5, 36, 54, 6), (2, 4, 32, 90, 2), (3, 2, 96, 160, 8),
            (1, 150, 16, 32, 8), (2, 1000, 16, 4, 4))
# B1 timed shapes: the ROIDet call, the reducto keep (reference + N
# frames), C = 16, and one block's chain (one pair, one band)
EM_TIMED = ((5, 10, 96, 160), (5, 11, 96, 160), (16, 10, 96, 160),
            (1, 2, 8, 160))
# B3 timed shapes (I, W+1): the main path at C = 5 and 16, and one camera
DP_TIMED = ((5, 128), (16, 128), (1, 128))


def em_plans(em_ops, sms, C, M, H, W, bs):
    """The launch plan, whole-row segments with as many pairs as fit, and
    one pair per chunk (every frame restaged per pair)."""
    nb = W // bs
    fit = max(p for p in range(1, M)
              if em_ops.smem_bytes(bs, nb, p) <= em_ops.MAX_SMEM_BYTES)
    return (em_ops.plan(C, M, H, W, bs, sms), (nb, fit), (nb, 1))


def check_edge_motion(torch, dev, cases: dict, bs: int, thr: float
                      ) -> float:
    """B1 against its plain version on the card, bitwise, one launch per
    call, under each of ``em_plans``: the main path's ``cases`` (name ->
    frames), EM_EXTRA on uniform frames, and an unaligned base (frames a
    view one float into a buffer, so that the kernel takes its 4-byte
    copies).  Returns the worst |diff|."""
    from repro_torch.common.device import sm_count
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.edge_motion import ref as em_ref
    sms = sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = {k: (v, bs) for k, v in cases.items()}
    for C, M, H, W, b in EM_EXTRA:
        cases[f"uniform bs={b}"] = (torch.rand((C, M, H, W), device=dev,
                                               generator=gen), b)
    # wide rows (640 floats) on the 4-byte path
    src = torch.rand((2, 4, 16, 640), device=dev, generator=gen)
    flat = torch.empty(src.numel() + 1, device=dev)
    unaligned = flat[1:].view(src.shape)
    unaligned.copy_(src)
    if unaligned.data_ptr() % 16 == 0 or not unaligned.is_contiguous():
        raise AssertionError("the unaligned case is aligned")
    cases["unaligned base"] = (unaligned, bs)
    from repro_torch.kernels import build
    smem_c = build.library("edge_motion").edge_motion_smem
    worst = 0.0
    for name, (fr, b) in cases.items():
        for seg, ppc in em_plans(em_ops, sms, *fr.shape, b):
            if smem_c(b, seg, ppc) != em_ops.smem_bytes(b, seg, ppc):
                raise AssertionError("the wrapper plans with another "
                                     "shared-memory size than the kernel")
        want = em_ref.segment_motion_ref(fr, block_size=b, edge_thresh=thr)
        for i, launch_plan in enumerate(em_plans(em_ops, sms, *fr.shape, b)):
            before = em_ops.LAUNCHES
            got = em_ops.edge_motion_cuda(fr, block_size=b, edge_thresh=thr) \
                if i == 0 else em_ops._launch(fr, b, thr, launch_plan)
            torch.cuda.synchronize()
            if em_ops.LAUNCHES != before + 1:
                raise AssertionError("edge_motion counted "
                                     f"{em_ops.LAUNCHES - before} launches")
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"edge_motion vs plain {name} {tuple(fr.shape)} bs={b} plan "
                  f"{launch_plan}: max |diff| {err} (sum "
                  f"{float(want.sum()):.0f})")
            if not torch.equal(got, want):
                raise AssertionError("edge_motion differs from its plain "
                                     "version")
    return worst


def check_knapsack(torch, dev, dp_cases) -> float:
    """B3 against its plain versions on the card: the sweep's values
    bitwise and choices equal to ``knapsack_dp_ref``'s, and the fused
    solve's picks and total equal to ``backtrack_device`` of the plain
    sweep at Wg = I, a middle value and W, one launch per call; the
    wrapper's shared-memory rule held to the library's.  Returns the worst
    |diff| of the values."""
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.knapsack_dp import ref as dp_ref
    smem_c = dp_ops._fns()[2]
    costs = torch.tensor(DP_COSTS, dtype=torch.int32, device=dev)
    worst = 0.0
    for I, W, kind, util in dp_cases:
        for solve in (0, 1):
            if smem_c(I, 6, W + 1, solve) != dp_ops.smem_bytes(I, 6, W + 1,
                                                               bool(solve)):
                raise AssertionError("the wrapper plans with another "
                                     "shared-memory size than the kernel")
        u = torch.from_numpy(util).to(dev)
        before = dp_ops.LAUNCHES
        vals, choices = dp_ops.knapsack_dp_cuda(u, costs, W)
        torch.cuda.synchronize()
        want_v, want_c = dp_ref.knapsack_dp_ref(u, costs, W)
        torch.cuda.synchronize()
        err = float((vals - want_v).abs().max())
        bad = int((choices != want_c).sum())
        worst = max(worst, err)
        line = (f"knapsack_dp vs plain ({I}, 6, {W + 1}) {kind}: max |diff| "
                f"values {err}, choices differing {bad}; solve (table in "
                + ("shared" if dp_ops.table_in_smem(I, 6, W + 1) else "device")
                + " memory) at Wg")
        if not (torch.equal(vals, want_v) and bad == 0):
            raise AssertionError("knapsack_dp differs from its plain version")
        for Wg in (I, (I + W) // 2, W):
            wg = torch.tensor(Wg, dtype=torch.int32, device=dev)
            picks, total = dp_ops.solve_device(u, costs, wg, w_cap=W)
            torch.cuda.synchronize()
            want_p, want_t = dp_ref.backtrack_device(want_c, costs, want_v, wg)
            ok = torch.equal(picks, want_p) and torch.equal(total, want_t)
            line += (f" {Wg}: picks {'equal' if ok else 'DIFFER'}, total "
                     f"{float(total):.6g}")
            if not ok:
                print(line)
                raise AssertionError("the fused knapsack solve differs from "
                                     "the plain backtrack")
        if dp_ops.LAUNCHES != before + 4:
            raise AssertionError(f"knapsack_dp counted "
                                 f"{dp_ops.LAUNCHES - before} launches for "
                                 "one sweep and three solves")
        print(line)
    # costs past one warp's 32 columns (the rotated registers), a zero
    # cost, and more options than the kernel keeps in registers
    gen = torch.Generator(device=dev).manual_seed(3)
    for cl, W in (((0, 33, 65, 100, 7, 300), 255),
                  ((1, 40, 64, 96, 129, 31, 2, 3, 5, 9, 17), 1023),
                  ((3, 70), 200), ((2, 5, 1, 7, 11, 13, 4, 8, 6), 127)):
        c = torch.tensor(cl, dtype=torch.int32, device=dev)
        for I in (1, 4, 9):
            u = torch.rand((I, len(cl)), device=dev, generator=gen)
            vals, choices = dp_ops.knapsack_dp_cuda(u, c, W)
            want_v, want_c = dp_ref.knapsack_dp_ref(u, c, W)
            wg = torch.tensor(W // 3, dtype=torch.int32, device=dev)
            picks, total = dp_ops.solve_device(u, c, wg, w_cap=W)
            want_p, want_t = dp_ref.backtrack_device(want_c, c, want_v, wg)
            torch.cuda.synchronize()
            if not (torch.equal(vals, want_v) and torch.equal(choices, want_c)
                    and torch.equal(picks, want_p)
                    and torch.equal(total, want_t)):
                raise AssertionError(f"knapsack_dp differs from its plain "
                                     f"version at costs {cl}, I={I}")
    print("knapsack_dp vs plain with costs past 32, a zero cost and 11 "
          "options (I = 1, 4, 9): values, choices, picks and totals equal")
    return worst


def kernel_times(torch, fn, plain, kname):
    """(kernel ms from the profiler (one kernel per call), plain ms, kernel
    and plain ms per call back to back on CUDA events, which include the
    host's launch gaps)."""
    return (one_kernel_ms(torch, fn, 100, kname)[0],
            device_ms(torch, plain, 10),
            timed("kernel", lambda: cuda_ms(torch, fn)),
            timed("plain", lambda: cuda_ms(torch, plain, iters=20)))


def bound(nbytes: float, ops: float) -> tuple:
    """(bound ms, what bounds it): bytes over the HBM rate or float32
    operations over the CUDA cores' rate, the larger."""
    from repro_torch.common.config import H100_SXM
    t_bytes, t_ops = nbytes / H100_SXM.hbm_bw, ops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def em_timed_frames(torch, dev, C: int, M: int, H: int, W: int):
    """B1's input at an EM_TIMED shape: scene frames of one slot (the
    reducto keep's reference frame first at M = 11); uniform frames at the
    floor shape."""
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            segments_device)
    if H != 96:
        return torch.rand((C, M, H, W), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    scene = DeviceScene(SceneConfig(seed=7, num_cameras=C), device=dev)
    fr = segments_device(scene.cfg, scene.params, scene.key, 3,
                         gt_pad=scene.G)[0]
    if M == 11:
        prev = segments_device(scene.cfg, scene.params, scene.key, 2,
                               gt_pad=scene.G)[0][:, -1:]
        fr = torch.cat([prev, fr], dim=1)
    return fr[:, :M].contiguous()


def tx_codec_record(torch, dev, tag: str) -> dict:
    """B2's times at (5, 10, 96, 160) (a slot of the C=5 scene, the three
    blur branches), with the identity branch alone, and at the profiling
    sweep's (30, 10, 96, 160) under ``at_shape``, each beside its plain
    version and its bound.  ``ms`` is the kernel time on the card;
    ``stream_ms`` back-to-back calls on CUDA events, the host's launch
    gaps included."""
    from repro_torch.common import prng
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            segments_device)
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    scene = DeviceScene(SceneConfig(seed=7, num_cameras=5), device=dev)
    frames = segments_device(scene.cfg, scene.params, scene.key, 3,
                             gt_pad=scene.G)[0].contiguous()
    C = frames.shape[0]
    keys = prng.fold_in(prng.PRNGKey(11, device=dev),
                        torch.arange(C, device=dev))
    noise = prng.normal(keys, frames.shape[1:])
    levels = torch.full((C,), 64.0, device=dev)
    sigma = torch.full((C,), 0.01, device=dev)
    kcam = torch.tensor([1, 2, 4, 1, 2], dtype=torch.int32, device=dev)
    sw_frames, sw_noise, sw_terms, sw_kcam = sweep_codec_inputs(torch, dev)
    out = {}
    for label, ops in (
            ("", (frames, noise, levels, sigma, kcam)),
            ("sweep ", (sw_frames, sw_noise, *sw_terms[0], sw_kcam))):
        ms, plain_ms, stream_ms, plain_stream_ms = kernel_times(
            torch, lambda o=ops: tx_ops.tx_codec_cuda(*o),
            lambda o=ops: tx_ref.tx_codec_ref(*o), "tx_codec_kernel")
        px = ops[0].numel()
        # frames and noise read once, decoded frames written once; pool sum
        # (up to 15 adds) + divide, quantise (3), fma, clip (2)
        bound_ms, bound_by = bound(4 * 3 * px, px * 8)
        print(f"kernel tx_codec {label}{tuple(ops[0].shape)}: "
              f"{ms * 1e3:.2f} us on the card ({stream_ms * 1e3:.2f} us per "
              f"call back to back), plain {plain_ms * 1e3:.2f} us "
              f"({plain_stream_ms * 1e3:.2f} us), bound "
              f"{bound_ms * 1e3:.4f} us ({bound_by}; "
              f"{100 * bound_ms / ms:.1f}% of it) {tag}")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "stream_ms": stream_ms,
                      "plain_stream_ms": plain_stream_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    # with every camera on the identity branch: no staged band, one round
    # of loads
    ones = torch.ones(C, dtype=torch.int32, device=dev)
    identity_ms = one_kernel_ms(torch, lambda: tx_ops.tx_codec_cuda(
        frames, noise, levels, sigma, ones), 100, "tx_codec_kernel")[0]
    print(f"kernel tx_codec {tuple(frames.shape)} identity branch only: "
          f"{identity_ms * 1e3:.2f} us on the card {tag}")
    return {"name": "tx_codec", "route": "cuda",
            "source": "src/repro_torch/csrc/tx_codec.cu",
            "replaces": "src/repro/kernels/tx_codec/tx_codec.py:78",
            "shape": list(frames.shape), **out[""], "library_ms": None,
            "identity_ms": identity_ms,
            "at_shape": {str(tuple(sw_frames.shape)): out["sweep "]}}


def scene_motion_masks(torch, dev, bs: int, thr: float) -> dict:
    """ROIDet's motion masks of slot 3 of the C = 5 and 16 scenes (seed
    7): what cc_label labels on the main path."""
    from repro_torch.core import roidet
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            segments_device)
    from repro_torch.kernels.edge_motion import ops as em_ops
    out = {}
    for C in (5, 16):
        scene = DeviceScene(SceneConfig(seed=7, num_cameras=C), device=dev)
        frames = segments_device(scene.cfg, scene.params, scene.key, 3,
                                 gt_pad=scene.G)[0]
        motion = (em_ops.segment_motion_fleet(
            frames, block_size=bs, edge_thresh=thr)
            > roidet.MOTION_THRESH).any(dim=1)
        out[f"C={C} scene {tuple(motion.shape)}"] = motion
    return out


def kernel_time_records(torch, dev, tag: str) -> list:
    """Phase 8's kernel times, taken first in the run: every kernel's
    record in two passes, the one-kernel windows of all five kernels
    (each held to all of its launches) before any other profiler window,
    then the plain versions' and the library calls' windows; each pass
    leaves the other's numbers NaN, and the two are merged."""
    global PART
    bs, thr = 8, 0.35

    def records() -> list:
        return [edge_motion_record(torch, dev, bs, thr, tag),
                tx_codec_record(torch, dev, tag),
                knapsack_record(torch, dev, tag),
                flash_decode_record(torch, dev, tag),
                cc_label_record(torch, dev, cc_cases(
                    torch, dev, scene_motion_masks(torch, dev, bs, thr)),
                    tag)]
    PART = "kernel"
    first = records()
    again = [w for w in WINDOWS if w[1] != w[2]]
    print(f"kernel times: {len(WINDOWS)} one-kernel windows, "
          f"{sum(c for _, c, _ in WINDOWS)} of "
          f"{sum(i for _, _, i in WINDOWS)} launches recorded; taken again "
          f"(fewer than all of their launches): {again or 'none'}")
    PART = "plain"
    merged = merge_records(first, records())
    PART = None
    json.dumps(merged, allow_nan=False)    # every number measured
    return merged


def merge_records(a, b):
    """The two passes' records of the same kernels, each number taken from
    the pass that measured it (the other holds NaN)."""
    if isinstance(a, dict):
        return {k: merge_records(v, b[k]) for k, v in a.items()}
    if isinstance(a, list):
        return [merge_records(x, y) for x, y in zip(a, b, strict=True)]
    if isinstance(a, float) and a != a:
        return b
    return a


def print_kernel_times(records: list, tag: str) -> None:
    for rec in records:
        shapes = {str(rec.get("shape")): rec, **rec.get("at_shape", {}),
                  **{f"valid {k}": v for k, v in rec.get("at_valid",
                                                         {}).items()}}
        for shape, r in shapes.items():
            lib = ("" if r.get("library_ms") is None else
                   f", library {r['library_ms'] * 1e3:.2f} us")
            print(f"kernel times {rec['name']} {shape}: "
                  f"{r['ms'] * 1e3:.2f} us on the card, plain "
                  f"{r['plain_ms'] * 1e3:.2f} us{lib}, bound "
                  f"{r['bound_ms'] * 1e3:.5f} us ({r['bound_by']}) {tag}")


def edge_motion_record(torch, dev, bs: int, thr: float, tag: str) -> dict:
    """B1's times at EM_TIMED (``em_timed_frames``), each beside its plain
    version and its bound.  The record holds the first shape; the others
    ride along under ``at_shape``."""
    from repro_torch.common.device import sm_count
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.edge_motion import ref as em_ref
    per = {}
    for C, M, H, W in EM_TIMED:
        fr = em_timed_frames(torch, dev, C, M, H, W)
        run = lambda f=fr: em_ops.edge_motion_cuda(  # noqa: E731
            f, block_size=bs, edge_thresh=thr)
        plain = lambda f=fr: em_ref.segment_motion_ref(  # noqa: E731
            f, block_size=bs, edge_thresh=thr)
        ms, plain_ms, stream_ms, plain_stream_ms = kernel_times(
            torch, run, plain, "edge_motion_kernel")
        px = C * M * H * W
        # frames read once, scores written once; per pixel of every frame a
        # Sobel |g|^2 (14 operations) and a compare, per pixel of every
        # pair an XOR and an add
        nbytes = 4 * (px + C * (M - 1) * (H // bs) * (W // bs))
        bound_ms, bound_by = bound(nbytes, px * 15 + C * (M - 1) * H * W * 2)
        launch_plan = em_ops.plan(C, M, H, W, bs, sm_count(dev))
        print(f"kernel edge_motion {(C, M, H, W)} bs={bs} plan {launch_plan}: "
              f"{ms * 1e3:.2f} us on the card ({stream_ms * 1e3:.2f} us per "
              f"call back to back), plain {plain_ms * 1e3:.2f} us "
              f"({plain_stream_ms * 1e3:.2f} us), bound {bound_ms * 1e3:.4f} "
              f"us ({bound_by}; {100 * bound_ms / ms:.1f}% of it) {tag}")
        per[str((C, M, H, W))] = {
            "ms": ms, "plain_ms": plain_ms, "stream_ms": stream_ms,
            "plain_stream_ms": plain_stream_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "plan": list(launch_plan)}
    first = per.pop(str(EM_TIMED[0]))
    return {"name": "edge_motion", "route": "cuda",
            "source": "src/repro_torch/csrc/edge_motion.cu",
            "replaces": "src/repro/kernels/edge_motion/edge_motion.py:48",
            "shape": list(EM_TIMED[0]), **first, "library_ms": None,
            "at_shape": per}


def knapsack_record(torch, dev, tag: str) -> dict:
    """B3's times: the fused solve (what the main path launches) at
    DP_TIMED and the sweep alone at (5, 6, 128), each beside its plain
    version (``knapsack_dp_ref``, then ``backtrack_device`` for the solve)
    and its bound; kernels per device solve from the profiler (raises if
    not one).  The record holds the solve at (5, 6, 128); the others ride
    along."""
    import numpy as np
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.knapsack_dp import ref as dp_ref
    costs = torch.tensor(DP_COSTS, dtype=torch.int32, device=dev)
    J = len(DP_COSTS)
    per = {}
    for I, wp1 in DP_TIMED:
        W = wp1 - 1
        util = torch.from_numpy(np.random.default_rng(I * 1000 + W).uniform(
            0, 1, (I, J)).astype(np.float32)).to(dev)
        wg = torch.tensor(W // 2, dtype=torch.int32, device=dev)
        solve = lambda u=util, w=wg, W=W: dp_ops.solve_device(  # noqa: E731
            u, costs, w, w_cap=W)

        def plain(u=util, w=wg, W=W):
            v, c = dp_ref.knapsack_dp_ref(u, costs, W)
            return dp_ref.backtrack_device(c, costs, v, w)

        # every kernel of the solve: one
        ms, per_solve = one_kernel_ms(torch, solve, 100,
                                      what="a device solve")
        plain_ms = device_ms(torch, plain, 10)
        stream_ms = timed("kernel", lambda: cuda_ms(torch, solve))
        plain_stream_ms = timed("plain", lambda: cuda_ms(torch, plain,
                                                         iters=20))
        # util, costs and Wg read once, picks and total written once; per
        # (i, w, j) an add, a compare and a select, then the walk
        nbytes = 4 * (I * J + J + 1) + 8 * I + 4
        bound_ms, bound_by = bound(nbytes, I * J * wp1 * 3 + 2 * wp1)
        print(f"kernel knapsack_dp solve ({I}, {J}, {wp1}) Wg {W // 2}: "
              f"{ms * 1e3:.2f} us on the card ({stream_ms * 1e3:.2f} us per "
              f"call back to back), {per_solve:g} kernel per solve; plain "
              f"{plain_ms * 1e3:.2f} us ({plain_stream_ms * 1e3:.2f} us); "
              f"bound "
              f"{bound_ms * 1e3:.5f} us ({bound_by}) {tag}")
        rec = {"ms": ms, "plain_ms": plain_ms, "stream_ms": stream_ms,
               "plain_stream_ms": plain_stream_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "kernels_per_solve": per_solve}
        if (I, wp1) == DP_TIMED[0]:
            s_ms, s_plain, s_stream, s_plain_stream = kernel_times(
                torch, lambda u=util, W=W: dp_ops.knapsack_dp_cuda(
                    u, costs, W),
                lambda u=util, W=W: dp_ref.knapsack_dp_ref(u, costs, W),
                "knapsack_dp")
            s_bound, s_by = bound(4 * (I * J + J + wp1 + I * wp1),
                                  I * J * wp1 * 3)
            print(f"kernel knapsack_dp sweep ({I}, {J}, {wp1}): "
                  f"{s_ms * 1e3:.2f} us on the card ({s_stream * 1e3:.2f} us "
                  f"back to back), plain {s_plain * 1e3:.2f} us, bound "
                  f"{s_bound * 1e3:.5f} us ({s_by}) {tag}")
            rec["sweep"] = {"ms": s_ms, "plain_ms": s_plain,
                            "stream_ms": s_stream,
                            "plain_stream_ms": s_plain_stream,
                            "bound_ms": s_bound, "bound_by": s_by}
        per[str((I, J, wp1))] = rec
    first = per.pop(str((DP_TIMED[0][0], J, DP_TIMED[0][1])))
    return {"name": "knapsack_dp", "route": "cuda",
            "source": "src/repro_torch/csrc/knapsack_dp.cu",
            "replaces": "src/repro/kernels/knapsack_dp/knapsack_dp.py:54",
            "shape": [DP_TIMED[0][0], J, DP_TIMED[0][1]], **first,
            "library_ms": None, "at_shape": per}


# -- the labeler (cc_label) and the graph-replayed episode (slice 6) -----

CC_TIMED = ("C=5 scene (5, 12, 20)", "C=16 scene (16, 12, 20)",
            "random (4, 68, 120)")


def serpentine(np, M: int, N: int):
    """One one-cell-wide path through every other row, joined at
    alternating ends: close to M*N/2 passes to label."""
    m = np.zeros((M, N), bool)
    m[::2] = True
    for r in range(1, M, 2):
        m[r, N - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def cc_cases(torch, dev, scene_masks: dict) -> dict:
    """cc_label's parity cases on the card: the scenes' motion masks (what
    ROIDet labels), empty and full masks, serpentines and random masks at
    68 x 120 (1080p at 16-pixel blocks)."""
    import numpy as np
    rng = np.random.default_rng(0)
    up = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    cases = dict(scene_masks)
    cases["empty (5, 12, 20)"] = torch.zeros((5, 12, 20), dtype=torch.bool,
                                             device=dev)
    cases["full (5, 12, 20)"] = torch.ones((5, 12, 20), dtype=torch.bool,
                                           device=dev)
    cases["serpentine (1, 12, 20)"] = up(serpentine(np, 12, 20)[None])
    cases["serpentine (1, 68, 120)"] = up(serpentine(np, 68, 120)[None])
    cases["random (4, 68, 120)"] = up(np.stack(
        [rng.uniform(size=(68, 120)) < p for p in (0.1, 0.3, 0.45, 0.6)]))
    return cases


def check_cc_label(torch, dev, cases: dict) -> float:
    """cc_label against its plain version on the card (labels), and the
    boxes built on its labels against those of the plain labels on the
    CPU: bitwise in every case."""
    from repro_torch.core import cc
    from repro_torch.kernels.cc_label import ops as cc_ops
    from repro_torch.kernels.cc_label import ref as cc_ref
    for name, m in cases.items():
        got = cc_ops.cc_label_cuda(m)
        torch.cuda.synchronize()
        want = cc_ref.cc_label_ref(m)
        boxes = [x.cpu() for x in cc.label_and_boxes(m)]
        boxes_cpu = cc.label_and_boxes(m.cpu())
        same = torch.equal(got, want) and all(
            torch.equal(a, b) for a, b in zip(boxes, boxes_cpu))
        print(f"cc_label vs plain {name}: labels "
              f"{'equal' if torch.equal(got, want) else 'DIFFER'}, boxes and "
              f"valid flags vs the plain labels on the CPU "
              f"{'equal' if same else 'DIFFER'}; {label_passes(torch, m)} "
              "passes of the plain loop")
        if not same:
            raise AssertionError(f"cc_label differs from its plain version "
                                 f"on {name}")
    return 0.0


def label_passes(torch, mask) -> int:
    """Sweeps of the plain propagation until nothing changes, plus the one
    that finds no change: the passes this mask needs (the kernel's
    in-place passes need no more)."""
    from repro_torch.kernels.cc_label import ref as cc_ref
    m = mask.cpu()
    C, M, N = m.shape
    labels = torch.where(m, torch.arange(M * N, dtype=torch.int32).reshape(
        1, M, N), cc_ref.INF)
    for passes in range(1, M * N + 1):
        nxt = cc_ref._propagate(labels, m)
        if torch.equal(nxt, labels):
            return passes
        labels = nxt
    return M * N


def cc_label_record(torch, dev, cases: dict, tag: str) -> dict:
    """cc_label's times at CC_TIMED, each beside its plain version and its
    bound.  The record holds the first shape; the others ride along."""
    from repro_torch.kernels.cc_label import ops as cc_ops
    from repro_torch.kernels.cc_label import ref as cc_ref
    per = {}
    for name in CC_TIMED:
        m = cases[name]
        C, M, N = m.shape
        ms, plain_ms, stream_ms, plain_stream_ms = kernel_times(
            torch, lambda m=m: cc_ops.cc_label_cuda(m),
            lambda m=m: cc_ref.cc_label_ref(m), "cc_label_kernel")
        passes = label_passes(torch, m)
        # the mask read once (a byte a cell), the labels written once; per
        # pass and cell four neighbour minimums and a compare
        bound_ms, bound_by = bound(5 * C * M * N, 5 * passes * C * M * N)
        print(f"kernel cc_label {name}: {ms * 1e3:.2f} us on the card "
              f"({stream_ms * 1e3:.2f} us per call back to back), {passes} "
              f"passes; plain {plain_ms * 1e3:.2f} us "
              f"({plain_stream_ms * 1e3:.2f} us); bound "
              f"{bound_ms * 1e3:.5f} us ({bound_by}) {tag}")
        per[name] = {"shape": [C, M, N], "passes": passes, "ms": ms,
                     "plain_ms": plain_ms, "stream_ms": stream_ms,
                     "plain_stream_ms": plain_stream_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    first = per.pop(CC_TIMED[0])
    return {"name": "cc_label", "route": "cuda",
            "source": "src/repro_torch/csrc/cc_label.cu",
            "replaces": "src/repro/core/cc.py:63", **first,
            "library_ms": None, "at_shape": per}


def event_ms(torch, run) -> float:
    """ms of one call of ``run`` between two CUDA events, the call ending
    in a host fetch (so the end event follows all of its work)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# each kernel's name in the card's records (CUPTI), for counting the
# launches of a graph replay, which runs the kernels without their wrappers
KERNEL_NAMES = {"edge_motion": "edge_motion_kernel",
                "tx_codec": "tx_codec_kernel", "knapsack_dp": "knapsack_dp_",
                "flash_decode": "fd_kernel", "cc_label": "cc_label_kernel"}


def recorded_launches(torch, run, want: dict, what: str,
                      windows: int = 3) -> dict:
    """Each hand-written kernel's launches in one call of ``run`` as the
    card recorded them (torch.profiler's CUPTI kernel records, counted by
    name), which must equal ``want``.  A window that records fewer (the
    profiler drops records now and then) is taken again, up to
    ``windows``; one that records more raises at once."""
    from torch.autograd import DeviceType
    for _ in range(windows):
        torch.cuda.synchronize()
        with profiler(torch, "the episodes' launch counts") as prof:
            run()
            torch.cuda.synchronize()
            time.sleep(0.05)    # the card's activity records arrive late
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
        got = {k: sum(e.count for e in kernels if name in e.key)
               for k, name in KERNEL_NAMES.items()}
        if any(got[k] > want[k] for k in want):
            raise AssertionError(f"{what}: the card ran {got}, not {want}")
        if got == want:
            return got
        print(f"{what}: the profiler recorded {got} of {want}; taking "
              "another window")
    raise AssertionError(f"{what}: the card ran {got}, not {want}")


def same_logs(a: dict, b: dict, what: str) -> None:
    """Every log key of two runs bitwise equal."""
    import numpy as np
    for k in a:
        if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
            raise AssertionError(f"{what}: key {k} differs")


def ptxas_lines(log: str) -> list:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its name (the mangled
    name's last identifier and template arguments), registers, stack
    frame and spill stores."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        mangled = re.search(r"'(\w+)'", block).group(1)
        name = mangled
        m = re.search(r"cu_[0-9a-f]{8}(\d+)", mangled)
        if m:
            start = m.end()
            name = mangled[start:start + int(m.group(1))]
            targs = re.findall(r"L[ib](\d+)E", mangled[start:])
            if targs:
                name += "<" + ", ".join(targs) + ">"
        regs = re.search(r"Used (\d+) registers", block)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", block)
        out.append(f"{name} "
                   f"{regs.group(1) if regs else '?'} registers, "
                   f"{frame.group(1) if frame else '?'} B stack, "
                   f"{frame.group(2) if frame else '?'} B spilled")
    return out


def sass_counts(lib_path) -> dict:
    """Tensor-core (HMMA, HGMMA) and TMA-load (UTMALDG) instructions in a
    built library's SASS, where the toolkit has cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "HGMMA", "UTMALDG")}


class TimedLM:
    """Passes calls to ``lm`` with a synchronize and a host clock around
    each, and keeps what the checks need: per call the kind, ms, position,
    rows and logits.  At decode call ``compare_at`` it first runs the same
    decode through the plain route (``use_kernel=False``, writing no cache
    row) and keeps both logits."""

    def __init__(self, torch, lm, compare_at=None):
        self.torch, self.lm, self.cfg = torch, lm, lm.cfg
        self.calls, self.compare_at, self.compared = [], compare_at, None
        self.n_decode = 0

    def init_cache(self, *a, **kw):
        return self.lm.init_cache(*a, **kw)

    def _timed(self, fn, *a, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        self.torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def prefill(self, params, batch, max_seq):
        from repro_torch.kernels.flash_decode import ops as fd_ops
        before = fd_ops.LAUNCHES
        (logits, cache), ms = self._timed(self.lm.prefill, params, batch,
                                          max_seq)
        if fd_ops.LAUNCHES != before:
            raise AssertionError("prefill launched flash_decode")
        self.calls.append(("prefill", ms, batch["tokens"].shape[1], None,
                           logits.float().cpu()))
        return logits, cache

    def decode(self, params, tokens, cache, pos, rows=None):
        if self.n_decode == self.compare_at:
            plain, _ = self.lm.decode(params, tokens, cache, pos, rows=[],
                                      use_kernel=False)
        (logits, cache), ms = self._timed(self.lm.decode, params, tokens,
                                          cache, pos, rows=rows)
        if self.n_decode == self.compare_at:
            self.compared = (pos, plain.float().cpu(), logits.float().cpu())
        self.n_decode += 1
        self.calls.append(("decode", ms, pos, rows, logits.float().cpu()))
        return logits, cache


def lm_card_vs_cpu(torch, dev) -> None:
    """The f32 smoke engine run of tests/test_torch_serve.py on the card
    and on the CPU, same seeded weights: tokens identical, every call's
    logits within 1e-4, flash_decode launched once per layer and decode
    call on the card."""
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = smoke_config("granite-8b").replace(dtype="float32", num_heads=8,
                                             num_kv_heads=2)
    lm = LM(cfg)
    cpu_params = lm.init(torch.Generator().manual_seed(0))
    runs = {}
    for where in ("cpu", dev):
        params = _to(torch, cpu_params, where)
        rng = np.random.default_rng(5)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=6)
                for i, n in enumerate(SMALL_PROMPTS)]
        rec = TimedLM(torch, lm)
        fd_ops.LAUNCHES = 0
        stats = ServeEngine(rec, params, batch_slots=4, max_seq=32,
                            device=where).run(reqs)
        runs[str(where)] = (stats, [r.out_tokens for r in reqs], rec.calls,
                            fd_ops.LAUNCHES, rec.n_decode)
    (cs, ctok, ccalls, _, _), (gs, gtok, gcalls, n_fd, n_dec) = (
        runs["cpu"], runs[str(dev)])
    diff = max(float((a[4] - b[4]).abs().max())
               for a, b in zip(ccalls, gcalls))
    print(f"LM engine f32 smoke (d=64, 2 layers, G=4, hd=8) card vs CPU: "
          f"{gs['requests']} requests, {gs['steps']} steps, tokens "
          f"{'identical' if gtok == ctok else 'DIFFERENT'}, max |logit diff| "
          f"{diff:.3g} over {len(gcalls)} calls; flash_decode launches "
          f"{n_fd} for {n_dec} decode calls")
    if gtok != ctok or gs["steps"] != cs["steps"] or len(gcalls) != len(
            ccalls) or not diff <= 1e-4:
        raise AssertionError("the card's LM engine differs from the CPU's")
    if n_fd != cfg.num_layers * n_dec or n_dec == 0:
        raise AssertionError("flash_decode not launched once per layer and "
                             "decode call")


def _to(torch, tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to(torch, v, device) for k, v in tree.items()}



def engine_run(torch, dev, lm, params, prompts, new: int, slots: int,
               max_seq: int, reset_counts, read_counts) -> dict:
    """ServeEngine over ``lm`` on ``params``: requests of ``prompts``
    tokens (seeded), ``new`` tokens each, on ``slots`` slots, every launch
    counter set to 0 just before the run and read just after.  Checks
    that every request drains, that flash_decode ran once per attention
    layer (``b4_per_decode``) and decode call and never in prefill, that
    no other kernel launched, that request 0's last decode logits agree
    with a prefill of the same tokens (teacher forcing) and that the
    kernel route agrees with ``use_kernel=False`` at the third decode,
    both within 5e-2 of max |logit| (tests/test_archs.py's bf16 rule).
    Returns the readings and the engine."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = lm.cfg
    arch = cfg.arch_id
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(prompts)]
    rec = TimedLM(torch, lm, compare_at=2)
    eng = ServeEngine(rec, params, batch_slots=slots, max_seq=max_seq,
                      device=dev)
    reset_counts()
    stats = eng.run(reqs)
    counts = read_counts()
    launches = counts.pop("flash_decode")
    pre = [c for c in rec.calls if c[0] == "prefill"]
    dec = [c for c in rec.calls if c[0] == "decode"]
    per_call = b4_per_decode(cfg)
    if not (stats["requests"] == len(reqs) and all(
            r.done and len(r.out_tokens) == new for r in reqs)):
        raise AssertionError(f"{arch}: not every request drained: {stats}")
    if launches != per_call * len(dec) or not dec or any(counts.values()):
        raise AssertionError(f"{arch}: flash_decode launched {launches} "
                             f"times for {len(dec)} decode calls of "
                             f"{per_call}; others {counts}")
    V = cfg.vocab_size
    # teacher forcing: request 0 (slot 0) made its last token at decode
    # position len(prompt) + new - 2, from out_tokens[-2] (a later
    # request in slot 0 may pass the same position)
    r0 = reqs[0]
    last = len(r0.prompt) + new - 2
    lg_dec = [c for c in dec if c[2] == last and (
        c[3] is None or 0 in c[3])][0][4][0, 0, :V]
    if int(lg_dec.argmax()) != r0.out_tokens[-1]:
        raise AssertionError(f"{arch}: the recorded decode logits did not "
                             "pick the emitted token")
    toks = np.concatenate([r0.prompt, r0.out_tokens[:-1]]).astype(np.int64)
    lg_pre, _ = lm.prefill(params, family_batch(
        torch, dev, cfg, torch.as_tensor(toks[None], device=dev)), max_seq)
    lg_pre = lg_pre.float().cpu()[0, 0, :V]
    pos_c, plain, kern = rec.compared
    out = {"stats": stats, "pre": pre, "dec": dec, "launches": launches,
           "per_call": per_call, "last": last, "pos_c": pos_c,
           "tf": (float((lg_dec - lg_pre).abs().max()),
                  float(lg_pre.abs().max())),
           "route": (float((plain[..., :V] - kern[..., :V]).abs().max()),
                     float(plain[..., :V].abs().max())),
           "engine": eng, "requests": reqs}
    if not (out["tf"][0] / out["tf"][1] < 5e-2
            and out["route"][0] / out["route"][1] < 5e-2):
        raise AssertionError(f"{arch}: decode disagrees with teacher "
                             f"forcing or with the plain route: {out['tf']}, "
                             f"{out['route']}")
    return out


def lm_full_width(torch, dev, tag: str, reset_counts, read_counts) -> int:
    """``engine_run`` over granite-8b at its published config (36 layers,
    d_model 4096, 32/8 heads, d_ff 14336, vocab 49152, bf16), weights from
    a seeded torch.Generator on the card: 4 slots, max_seq 2048, prompts of
    512, 512, 384, 384, 512 and 256 tokens, 16 new tokens each; then one
    profiled decode and the host syncs of one decode call.  Returns the
    flash_decode launches of the engine run."""
    from repro_torch.common.config import H100_SXM
    from repro_torch.common.params import param_count
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    cfg = get_config("granite-8b")
    lm = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(lm.param_defs())
    run = engine_run(torch, dev, lm, params, FULL_PROMPTS, FULL_NEW,
                     FULL_SLOTS, FULL_SEQ, reset_counts, read_counts)
    peak = torch.cuda.max_memory_allocated()
    stats, pre, dec, launches = (run["stats"], run["pre"], run["dec"],
                                 run["launches"])
    eng = run["engine"]
    pre_ms = [c[1] for c in pre]
    dec_ms = [c[1] for c in dec]
    step_ms = (stats["wall_s"] * 1e3 - sum(pre_ms)) / stats["steps"]
    print(f"granite-8b full width ({n_params:,} parameters, bf16, init "
          f"{init_s:.2f} s on the card): {stats['requests']} requests, "
          f"{stats['tokens']} tokens, {stats['steps']} steps, "
          f"{len(dec)} decode calls, flash_decode launches {launches} "
          f"(= {cfg.num_layers} x {len(dec)}), none in {len(pre)} prefills "
          f"{tag}")
    print(f"granite-8b prefill ms per request (prompt "
          f"{[c[2] for c in pre]}): {[round(x, 3) for x in pre_ms]} {tag}")
    RECORDED["measured"]["granite-8b decode"] = statistics.median(dec_ms)
    print(f"granite-8b decode ms per call: median "
          f"{statistics.median(dec_ms):.3f} (min {min(dec_ms):.3f}, max "
          f"{max(dec_ms):.3f}, {len(dec_ms)} calls); per engine step "
          f"{step_ms:.3f} ms; {stats['tok_per_s']:.2f} tokens/s over "
          f"{stats['wall_s']:.3f} s; peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes) {tag}")
    (e_tf, scale), (e_route, s_route) = run["tf"], run["route"]
    print(f"granite-8b teacher forcing (request 0, position {run['last']}): "
          f"max |decode - prefill| {e_tf:.4g} of max |logit| {scale:.4g} "
          f"({e_tf / scale:.4g}); kernel vs plain route at decode position "
          f"{run['pos_c']}: {e_route:.4g} of {s_route:.4g} "
          f"({e_route / s_route:.4g})")
    # one profiled decode of all 4 slots at the position the run reached
    # (a masked decode, as the engine ran; the run is over, so writing the
    # two rows at this position changes nothing that is read again)
    tokens = torch.zeros((FULL_SLOTS, 1), dtype=torch.long, device=dev)
    pos = max(FULL_PROMPTS) + FULL_NEW
    lm.decode(params, tokens, eng.cache, pos, rows=[0, 1])
    torch.cuda.synchronize()
    with profiler(torch, "granite-8b's profiled decode") as prof:
        t0 = time.perf_counter()
        lm.decode(params, tokens, eng.cache, pos, rows=[0, 1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    busy = device_us(prof) / 1e3
    fd = device_us(prof, "fd_") / 1e3
    n_fd = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "fd_" in e.key)
    if n_fd != cfg.num_layers:
        raise AssertionError(f"the profiled decode ran {n_fd} flash_decode "
                             f"kernels for {cfg.num_layers} layers")
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    gemm = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and any(w in e.key.lower() for w in
                       ("gemm", "gemv", "nvjet", "cutlass"))) / 1e3
    print(f"granite-8b one decode (4 slots, 2 rows written, position {pos}) "
          f"under the "
          f"profiler: wall {wall:.3f} ms, kernels {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% busy) in {n_kernels} kernels, "
          f"flash_decode {fd:.3f} ms in {n_fd} kernels (one per layer), "
          f"matrix products {gemm:.3f} ms, weights-read floor "
          f"{2 * n_params / H100_SXM.hbm_bw * 1e3:.3f} ms {tag}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12))
    sites = syncs_of(torch, lambda: lm.decode(params, tokens, eng.cache, pos,
                                              rows=[0, 1]))
    print(f"granite-8b host syncs in one decode call: "
          f"{sum(sites.values())} {sites}")
    del params, eng, run
    torch.cuda.empty_cache()
    return launches


def flash_decode_record(torch, dev, tag: str) -> dict:
    """B4's times at the LM decode's shape in bf16, at the valid lengths
    FD_TIMED: the kernel (profiler), the plain version, and
    scaled_dot_product_attention with the same mask (enable_gqa) as the
    library yardstick, beside the bound.  The record holds the first
    length (where the run sits); the others ride along under
    ``at_valid``."""
    from repro_torch.common.config import H100_SXM
    from repro_torch.common.device import sm_count
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    F = torch.nn.functional
    B, S, H, KV, hd = FD_SHAPE
    q, k, v, _, _ = fd_inputs(torch, dev, torch.bfloat16, *FD_SHAPE)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    per = {}
    for vl in FD_TIMED:
        mask = (torch.arange(S, device=dev) < vl)[None, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        want = fd_ref.flash_decode_ref(q, k, v, kv_valid_len=vl)[0]
        e_lib = float((lib().transpose(1, 2).float() - want.float())
                      .abs().max())
        # per recorded kernel: the profiler may miss a window's first few
        ms, per_call = one_kernel_ms(
            torch, lambda: fd_ops.flash_decode_cuda(q, k, v, vl), 100, "fd_",
            "flash_decode")
        plain_ms = device_ms(torch, lambda: fd_ref.flash_decode_ref(
            q, k, v, kv_valid_len=vl), 10)
        library_ms = device_ms(torch, lib, 20)
        # K and V rows below vl read once; q read, out, m and l written
        nbytes = 2 * B * vl * KV * hd * 2 + 2 * B * H * hd * 2 + 2 * B * H * 4
        flops = 4 * B * H * vl * hd
        t_bytes = nbytes / H100_SXM.hbm_bw
        t_ops = flops / H100_SXM.peak_flops
        bound_ms = max(t_bytes, t_ops) * 1e3
        tiles, nsplit, stages = fd_ops.split_plan(
            vl, B * KV, sm_count(dev), H // KV, hd, 2)
        print(f"kernel flash_decode {FD_SHAPE} bf16 valid {vl} ({nsplit} "
              f"ranges of {tiles} tiles x {B * KV} blocks, {stages} stages, "
              f"{per_call:g} kernel per call): {ms * 1e3:.2f} us on the card, "
              f"plain {plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} "
              f"us (max |diff| vs plain {e_lib:.3g}), bound "
              f"{bound_ms * 1e3:.3f} us ({nbytes} bytes, {flops} flops; "
              f"{100 * bound_ms / ms:.1f}% of it) {tag}")
        per[vl] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    first = per[FD_TIMED[0]]
    from repro_torch.kernels import build
    sass = sass_counts(build.library_path("flash_decode"))
    if sass and not sass["HMMA"] + sass["HGMMA"]:
        raise AssertionError("flash_decode's SASS has no tensor-core "
                             "instruction")
    products = ("wgmma" if sass.get("HGMMA") else "mma.sync") if sass \
        else "mma.sync (source; no cuobjdump)"
    print(f"flash_decode SASS: {sass or 'cuobjdump not found'}; bf16 "
          f"products by {products}")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:66",
            "shape": list(FD_SHAPE), "valid_len": FD_TIMED[0], **first,
            "bf16_products": products, "sass": sass,
            "at_valid": {str(vl): per[vl] for vl in FD_TIMED[1:]}}



# -- the other LM families and the int8 cache (slice 10) -----------------

# served through ServeEngine at full width: (arch, layers kept or None)
FAM_SERVE = (("olmoe-1b-7b", None), ("zamba2-7b", None),
             ("xlstm-125m", None), ("qwen1.5-4b", None),
             ("llama-3.2-vision-90b", 10))
FAM_PROMPTS = (256, 256, 192, 192)   # two position groups on 4 slots
FAM_NEW, FAM_SLOTS, FAM_SEQ = 8, 4, 1024
AUDIO_ROWS, AUDIO_PROMPT = 2, 256    # seamless: prefill + decode, LM level
# trained: (arch, layers kept or None, rows, tokens a row)
FAM_TRAIN = (("xlstm-125m", None, 8, 512), ("olmoe-1b-7b", 4, 4, 4096))
FAM_TIMED = 3            # timed train steps after one warm-up
# why a depth is cut (the published config does not fit in 80 GB)
FAM_CUTS = {
    ("serve", "llama-3.2-vision-90b"): "20 superblocks of 4 self + 1 "
    "cross layer are 87.7 B parameters (175 GB in bf16); 2 superblocks "
    "keep every shape",
    ("train", "xlstm-125m"): "rows of 512 tokens, not train_4k's 4096: "
    "the sLSTM steps token by token (~10 s a step at 4 x 1024 tokens)",
    ("train", "olmoe-1b-7b"): "16 layers are 6.9 B parameters: bf16 "
    "weights and gradients plus float32 AdamW moments (~12 bytes a "
    "parameter, 83 GB) do not fit beside the activations"}


def b4_per_decode(cfg) -> int:
    """flash_decode launches in one decode call: one per self-attention
    layer and one per cross-attention layer."""
    f = cfg.family
    if f in ("dense", "moe"):
        return cfg.num_layers
    if f == "ssm":
        return 0
    if f == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    if f == "vlm":
        return cfg.num_layers // cfg.vlm.cross_attn_every * \
            cfg.vlm.cross_attn_every
    return 2 * cfg.encdec.dec_layers


def matmul_params(lm) -> int:
    """Parameters a token meets in matrix products: every leaf of two or
    more axes but the embedding table, of the MoE experts top_k of
    num_experts."""
    import numpy as np
    cfg = lm.cfg

    def walk(defs, path):
        if hasattr(defs, "shape"):
            n = int(np.prod(defs.shape))
            if len(defs.shape) < 2 or path[-2:] == ("embed", "tok"):
                return 0
            if path[-1] in ("w_gate", "w_up", "w_down"):
                return n * cfg.moe.top_k // cfg.moe.num_experts
            return n
        return sum(walk(v, path + (k,)) for k, v in defs.items())
    return walk(lm.param_defs(), ())


def mfu_text(cfg, rows: int, seq: int, microbatches: int, flops: float,
             ms: float) -> str:
    """A train step's MFU over H100_SXM's dense bf16 peak, counted as
    ``flops`` (6 x the parameters a token meets in matrix products + 12 L
    H hd S: the products the step runs, the input embedding's gather out
    and every masked attention chunk in, as the chunked attention computes
    them), beside the analytic roofline's ``model_flops`` (6 N with the
    input embedding + causal attention at half) and the roofline's
    one-card step time."""
    from repro_torch.common.config import H100_SXM, ShapeCell
    from repro_torch.roofline.analytic import MeshDims, analytic_terms
    terms = analytic_terms(cfg, ShapeCell("chip_smoke", seq, rows, "train"),
                           microbatches, MeshDims(1, 1, 1), H100_SXM)
    sec, peak = ms / 1e3, H100_SXM.peak_flops
    return (f"MFU {100 * flops / sec / peak:.2f}% (6 N_matmul + 12 L H hd "
            f"S: {flops / 1e12:.2f} TFLOP a step); "
            f"{100 * terms['model_flops'] / sec / peak:.2f}% by the analytic "
            f"model_flops ({terms['model_flops'] / 1e12:.2f} TFLOP) over "
            f"{peak / 1e12:.0f} TFLOP/s; roofline step "
            f"{terms['a_step_s'] * 1e3:.1f} ms ({terms['a_bottleneck']})")


def syncs_of(torch, fn) -> dict:
    """Host syncs of one call of ``fn`` per site
    (``set_sync_debug_mode("warn")``)."""
    import collections
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return dict(collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                    for w in caught))


def family_config(arch: str, layers):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def family_batch(torch, dev, cfg, tokens, seed=None) -> dict:
    """A prefill batch: the vlm's image embeddings (zero, as the engine
    gives them, or seeded normals) and the audio family's encoder
    embeddings (seeded normals, one per prompt position)."""
    batch = {"tokens": tokens}
    g = None if seed is None else torch.Generator(device=dev).manual_seed(
        seed)
    dt = getattr(torch, cfg.dtype)

    def embeds(n):
        shape = (tokens.shape[0], n, cfg.d_model)
        if g is None:
            return torch.zeros(shape, dtype=dt, device=dev)
        return torch.randn(shape, generator=g, device=dev).to(dt)
    if cfg.family == "vlm":
        batch["img_embeds"] = embeds(cfg.vlm.num_image_tokens)
    if cfg.family == "audio":
        batch["enc_embeds"] = embeds(tokens.shape[1])
    return batch


def lm_loop(torch, dev, lm, params, batch, new: int, max_seq: int) -> dict:
    """LM-level serving of one batch: prefill, then ``new`` greedy decode
    steps through the kernel route; at the second step the plain route
    (writing nothing) is held to the kernel route, and the last step's
    logits to a prefill of every token (teacher forcing), both within
    5e-2 of max |logit|.  Returns the readings."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    V = lm.cfg.vocab_size
    n = batch["tokens"].shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = lm.prefill(params, batch, max_seq)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    toks = [batch["tokens"], lg[:, :, :V].argmax(-1)]
    dec_ms, e_route, s_route = [], None, None
    fd0 = fd_ops.LAUNCHES
    for i in range(new):
        if i == 1:
            plain, _ = lm.decode(params, toks[-1], cache, n + i, rows=[],
                                 use_kernel=False)
            launched = fd_ops.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = lm.decode(params, toks[-1], cache, n + i)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            per_call = fd_ops.LAUNCHES - launched
            e_route = float((plain - lg)[..., :V].float().abs().max())
            s_route = float(plain[..., :V].float().abs().max())
        toks.append(lg[:, :, :V].argmax(-1))
    full = dict(batch, tokens=torch.cat(toks[:-1], dim=1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg_tf, _ = lm.prefill(params, full, max_seq)
    torch.cuda.synchronize()
    pre_ms = (pre_ms, (time.perf_counter() - t0) * 1e3)
    e_tf = float((lg_tf - lg)[..., :V].float().abs().max())
    s_tf = float(lg_tf[..., :V].float().abs().max())
    if not (e_tf / s_tf < 5e-2 and e_route / s_route < 5e-2):
        raise AssertionError(f"{lm.cfg.arch_id}: decode disagrees with "
                             "teacher forcing or with the plain route")
    return {"prefill_ms": pre_ms, "decode_ms": dec_ms, "tf": (e_tf, s_tf),
            "route": (e_route, s_route), "b4_per_call": per_call,
            "b4": fd_ops.LAUNCHES - fd0,
            "tokens": toks[1:], "cache": cache}


def serve_family(torch, dev, tag: str, arch: str, layers, reset_counts,
                 read_counts) -> int:
    """``engine_run`` over one config at its published width (depth as
    given), seeded random bf16 weights made on the card: 4 requests of
    FAM_PROMPTS tokens on 4 slots (two position groups, so grouped
    decodes run), FAM_NEW new tokens each.  For the vlm, an LM-level run
    with seeded image embeddings too (the engine gives zeros, as JAX's
    does).  Returns the flash_decode launches of the runs."""
    import numpy as np
    from repro_torch.common.params import param_count
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.model import LM
    cfg = family_config(arch, layers)
    lm = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if layers is not None:
        RECORDED["allocated"][(arch, "serve", layers)] = {
            "weights_bytes": tree_bytes(params)}
    n_params = param_count(lm.param_defs())
    run = engine_run(torch, dev, lm, params, FAM_PROMPTS, FAM_NEW,
                     FAM_SLOTS, FAM_SEQ, reset_counts, read_counts)
    peak = torch.cuda.max_memory_allocated()
    stats, pre, dec, launches = (run["stats"], run["pre"], run["dec"],
                                 run["launches"])
    dec_ms = [c[1] for c in dec]
    tokens = torch.zeros((FAM_SLOTS, 1), dtype=torch.long, device=dev)
    pos = max(FAM_PROMPTS) + FAM_NEW
    syncs = syncs_of(torch, lambda: lm.decode(
        params, tokens, run["engine"].cache, pos, rows=[0, 1]))
    full_layers = family_config(arch, None).num_layers
    (e_tf, s_tf), (e_route, s_route) = run["tf"], run["route"]
    print(f"families serve {arch} ({cfg.family}, {cfg.num_layers} of "
          f"{full_layers} layers, d_model {cfg.d_model}, {n_params:,} "
          f"parameters, bf16, {cfg.kv_cache_dtype} cache; init {init_s:.2f} s"
          f" on the card): {stats['requests']} requests, {stats['tokens']} "
          f"tokens, {stats['steps']} steps, {len(dec)} decode calls; prefill "
          f"ms {[round(c[1], 2) for c in pre]} (prompts "
          f"{[c[2] for c in pre]}); decode ms per call median "
          f"{statistics.median(dec_ms):.3f} (min {min(dec_ms):.3f}, max "
          f"{max(dec_ms):.3f}); {stats['tok_per_s']:.2f} tokens/s; "
          f"flash_decode {run['per_call']} per decode call ({launches} in "
          f"all, none in prefill); host syncs in one decode call "
          f"{sum(syncs.values())} {syncs}; peak memory {peak / 2**30:.3f} GiB"
          f" {tag}")
    print(f"families serve {arch}: teacher forcing (request 0, position "
          f"{run['last']}) max |decode - prefill| {e_tf:.4g} of {s_tf:.4g} "
          f"({e_tf / s_tf:.4g}); kernel vs plain route at position "
          f"{run['pos_c']}: {e_route:.4g} of {s_route:.4g} "
          f"({e_route / s_route:.4g})")
    cut = FAM_CUTS.get(("serve", arch))
    if cut:
        print(f"families reduced: serve {arch} at {cfg.num_layers} of "
              f"{full_layers} layers: {cut}")
    if cfg.family == "vlm":
        toks = torch.as_tensor(np.stack([r.prompt[:FAM_PROMPTS[-1]]
                                         for r in run["requests"]]
                                        ).astype(np.int64), device=dev)
        del run
        out = lm_loop(torch, dev, lm, params,
                      family_batch(torch, dev, cfg, toks, seed=1), FAM_NEW,
                      FAM_SEQ)
        launches += out["b4"]
        print(f"families serve {arch} LM level with seeded image embeddings "
              f"({toks.shape[0]} rows, {cfg.vlm.num_image_tokens} image "
              f"tokens, every one valid in the cross decode): prefill "
              f"{out['prefill_ms'][0]:.2f} ms ({FAM_PROMPTS[-1]} tokens; "
              f"{out['prefill_ms'][1]:.2f} ms for {FAM_PROMPTS[-1] + FAM_NEW})"
              f", decode ms per call median "
              f"{statistics.median(out['decode_ms']):.3f}; teacher forcing "
              f"{out['tf'][0]:.4g} of {out['tf'][1]:.4g}; kernel vs plain "
              f"route {out['route'][0]:.4g} of {out['route'][1]:.4g}; "
              f"flash_decode {out['b4_per_call']} per decode call")
    del params
    torch.cuda.empty_cache()
    return launches


def audio_family(torch, dev, tag: str, reset_counts, read_counts) -> int:
    """seamless-m4t-large-v2 at its published width and depth (24
    encoder + 24 decoder layers), seeded random bf16 weights, at the LM
    level (the engine refuses the family): AUDIO_ROWS prompts of
    AUDIO_PROMPT tokens with seeded encoder embeddings, prefill, FAM_NEW
    greedy decode steps; decode = teacher forcing and the kernel route =
    the plain one within 5e-2 of max |logit|.  Returns the flash_decode
    launches of the run."""
    from repro_torch.common.params import param_count
    from repro_torch.models.model import LM
    cfg = family_config("seamless-m4t-large-v2", None)
    lm = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (AUDIO_ROWS, AUDIO_PROMPT),
                         generator=g, device=dev)
    reset_counts()
    out = lm_loop(torch, dev, lm, params,
                  family_batch(torch, dev, cfg, toks, seed=1), FAM_NEW,
                  2 * AUDIO_PROMPT)
    counts = read_counts()
    launches = counts.pop("flash_decode")
    per_call = b4_per_decode(cfg)
    # FAM_NEW kernel-route calls; the plain-route call launches none
    if out["b4_per_call"] != per_call or launches != per_call * FAM_NEW \
            or any(counts.values()):
        raise AssertionError(f"seamless: flash_decode launched {launches} "
                             f"({out['b4_per_call']} a call), not "
                             f"{per_call} x {FAM_NEW}; others {counts}")
    peak = torch.cuda.max_memory_allocated()
    x = out["tokens"][-1]
    syncs = syncs_of(torch, lambda: lm.decode(
        params, x, out["cache"], AUDIO_PROMPT + FAM_NEW, rows=[]))
    d = out["decode_ms"]
    print(f"families serve seamless-m4t-large-v2 (audio, {cfg.encdec.enc_layers}"
          f" + {cfg.encdec.dec_layers} layers, d_model {cfg.d_model}, "
          f"{param_count(lm.param_defs()):,} parameters, bf16; LM level, "
          f"{AUDIO_ROWS} rows of {AUDIO_PROMPT} tokens and encoder "
          f"embeddings): prefill {out['prefill_ms'][0]:.2f} ms (the first "
          f"call; the teacher-forcing prefill of {AUDIO_PROMPT + FAM_NEW} "
          f"tokens {out['prefill_ms'][1]:.2f} ms); decode ms per "
          f"call median {statistics.median(d):.3f} (min {min(d):.3f}, max "
          f"{max(d):.3f}); {AUDIO_ROWS * FAM_NEW / (sum(d) / 1e3):.2f} "
          f"tokens/s over the decode calls; flash_decode {per_call} per "
          f"decode call (self and cross); host syncs in one decode call "
          f"{sum(syncs.values())} {syncs}; peak memory {peak / 2**30:.3f} GiB"
          f" {tag}")
    print(f"families serve seamless-m4t-large-v2: teacher forcing "
          f"{out['tf'][0]:.4g} of {out['tf'][1]:.4g} "
          f"({out['tf'][0] / out['tf'][1]:.4g}); kernel vs plain route "
          f"{out['route'][0]:.4g} of {out['route'][1]:.4g}")
    del params, out
    torch.cuda.empty_cache()
    return launches


def train_family(torch, dev, tag: str, arch: str, layers, rows: int,
                 seq: int, reset_counts, read_counts) -> None:
    """One config at its published width (depth as given), seeded random
    bf16 weights, its own MICROBATCHES["train_4k"] and MOMENT_DTYPE, rows
    of ``seq`` tokens: the loss falls over 3 steps on a fixed batch, then
    FAM_TIMED steps on the loader's batches after a warm-up: median
    ms/step (CUDA events), tokens/s, MFU (6 x the parameters a token
    meets in matrix products, plus 12 L H hd S for attention, over 989
    TFLOP/s), peak memory; no hand-written kernel launched."""
    import importlib
    from repro_torch.common.config import OptimizerConfig, RunConfig
    from repro_torch.configs import canonical
    from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                           SyntheticTokenSource)
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.model import LM
    from repro_torch.train.steps import init_train_state, make_train_step
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    cfg = family_config(arch, layers)
    mb = mod.MICROBATCHES["train_4k"]
    run = RunConfig(model=cfg, opt=OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=100,
        moment_dtype=mod.MOMENT_DTYPE), microbatches=mb)
    lm = LM(cfg)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, opt = init_train_state(lm, run, torch.Generator(
        device=dev).manual_seed(0))
    if layers is not None:
        RECORDED["allocated"][(arch, "train", layers)] = {
            "weights_bytes": tree_bytes(params),
            "adamw_bytes": tree_bytes(opt)}
    step = make_train_step(lm, run, donate=True)
    src = SyntheticTokenSource(DataConfig(rows, seq, cfg.vocab_size))
    fixed = {k: torch.as_tensor(v, device=dev)
             for k, v in src.batch_at(0).items()}
    curve = []
    for _ in range(3):
        params, opt, m = step(params, opt, fixed)
        curve.append(m["loss"])
    with torch.no_grad():
        curve.append(lm.loss(params, fixed)[0])
    curve = torch.stack(curve).tolist()
    aux = {k: float(v) for k, v in m.items() if k.startswith("moe_")}
    loader = PrefetchLoader(src, dev)
    it = iter(loader)
    params, opt, m = step(params, opt, next(it))     # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for _ in range(FAM_TIMED):
        batch = next(it)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    loader.close()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(ms)
    tokens = rows * seq
    n_mm = matmul_params(lm)
    n_attn = cfg.num_layers if cfg.family in ("dense", "moe") else 0
    flops = tokens * (6 * n_mm + 12 * n_attn * cfg.num_heads
                      * cfg.resolved_head_dim * seq)
    counts = read_counts()
    cut = FAM_CUTS.get(("train", arch))
    full_layers = family_config(arch, None).num_layers
    print(f"families train {arch} ({cfg.family}, {cfg.num_layers} of "
          f"{full_layers} layers, d_model {cfg.d_model}, bf16 weights, "
          f"{mod.MOMENT_DTYPE} moments, remat {cfg.remat_policy}, {mb} "
          f"microbatch{'es' if mb > 1 else ''}, {rows} x {seq} tokens): fixed "
          f"batch loss before each of 3 steps and after "
          f"{[round(x, 4) for x in curve]} {aux}; median {med:.1f} ms/step "
          f"(min {min(ms):.1f}, max {max(ms):.1f}, {FAM_TIMED} steps after a "
          f"warm-up, CUDA events); {tokens / med * 1e3:,.0f} tokens/s; "
          f"{mfu_text(cfg, rows, seq, mb, flops, med)}; {n_mm:,} matmul "
          f"parameters a token; peak memory {peak / 2**30:.2f} GiB; "
          f"hand-written "
          f"kernels {counts} {tag}")
    if cut:
        print(f"families reduced: train {arch} at {cfg.num_layers} of "
              f"{full_layers} layers, {rows} x {seq} tokens: {cut}")
    if not all(b < a for a, b in zip(curve, curve[1:])):
        raise AssertionError(f"{arch}: 3 steps did not lower the loss")
    if any(counts.values()):
        raise AssertionError(f"{arch}: the trainer launched a hand-written "
                             f"kernel {counts}")
    del params, opt, m, fixed, batch
    torch.cuda.empty_cache()


def families_phase(torch, dev, tag: str, reset_counts, read_counts) -> int:
    """Every family but the dense one, and the int8 cache, at published
    width: serving (FAM_SERVE through the engine, the audio family at the
    LM level) and training (FAM_TRAIN).  Returns the flash_decode
    launches of the serving runs."""
    launches = 0
    for arch, layers in FAM_SERVE:
        launches += serve_family(torch, dev, tag, arch, layers,
                                 reset_counts, read_counts)
    launches += audio_family(torch, dev, tag, reset_counts, read_counts)
    for arch, layers, rows, seq in FAM_TRAIN:
        train_family(torch, dev, tag, arch, layers, rows, seq, reset_counts,
                     read_counts)
    return launches


# -- offline profiling, Fig. 3 and the control scan (slice 7) -------------

PROFILE_SLOTS, PROFILE_STEPS = 8, 700   # benchmarks/common.py, full setting
PROFILE_CPU_SLOTS, PROFILE_CPU_STEPS = 2, 120
FIT_TOL = 1e-5           # fitted parameters, tests/test_torch_profile.py
FIG3_SLOTS = 16
FIG3_CPU_SLOTS = 4
FIG3_METHODS = ("deepstream", "deepstream_no_elastic", "jcab", "reducto",
                "static")
PAPER_WEIGHTS = (0.84, 0.38, 1.92, 0.74, 0.45)   # paper section 7.2


def sweep_codec_inputs(torch, dev):
    """B2's operands in one fleet call of the profiling sweep at full
    width: a slot of ``MultiCameraScene(SceneConfig(seed=42))``, ROIDet's
    masks on the card, the C*R*2 = 30 entries laid out (camera,
    resolution, masked/full) as ``_profile_slot_batched`` lays them out
    (masked entries cropped to their ROI, each entry's resolution picking
    its blur branch).  Returns (frames (30, 10, 96, 160), noise, per
    bitrate (levels, sigma), kcam)."""
    import numpy as np
    from repro_torch.common import prng
    from repro_torch.common.device import upload
    from repro_torch.core import codec, roidet
    from repro_torch.data.synthetic import MultiCameraScene, SceneConfig
    from repro_torch.models.detector import load_detector
    cfg, bs = codec.CodecConfig(), 8
    seg = MultiCameraScene(SceneConfig(seed=42)).segment()
    frames = upload(seg["frames"], dev, np.float32)
    C, N = frames.shape[:2]
    R = len(cfg.resolutions)
    B = C * R * 2
    roi = roidet.roidet_fleet(frames, load_detector("light", dev),
                              block_size=bs)
    masks_cr = torch.stack([roi.mask, torch.ones_like(roi.mask)], dim=1)
    masks_b = masks_cr[:, None].expand(C, R, *masks_cr.shape[1:]).reshape(
        B, *masks_cr.shape[2:])
    cropped = roidet.crop_to_mask(frames.repeat_interleave(R * 2, dim=0),
                                  masks_b, bs).contiguous()
    roi_px = (masks_b.sum(dim=(1, 2)) * bs * bs).to(torch.float32)
    tables = codec.device_tables(cfg.bitrates_kbps, cfg.resolutions, dev)
    r_b = tables.resolutions.repeat(C).repeat_interleave(2)
    kcam = tables.pool_factors[codec.nearest_resolution(
        tables.resolutions, r_b)].contiguous()
    keys = prng.fold_in(prng.PRNGKey(17, device=dev),
                        torch.arange(B, device=dev))
    noise = prng.normal(keys, cropped.shape[1:]).contiguous()
    n_eff = torch.full((B,), float(N), device=dev)
    terms = [tuple(x.contiguous() for x in codec.rate_terms(
        cfg, roi_px, torch.full((B,), float(b), device=dev), r_b, n_eff)[:2])
        for b in cfg.bitrates_kbps]
    return cropped, noise, terms, kcam


def check_tx_codec_sweep(torch, dev) -> float:
    """B2 against its plain version at the sweep's shape, once per bitrate
    of a profiled slot: bitwise.  Returns the worst |diff|."""
    from repro_torch.core import codec
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    frames, noise, terms, kcam = sweep_codec_inputs(torch, dev)
    worst = 0.0
    for b, (levels, sigma) in zip(codec.CodecConfig().bitrates_kbps, terms):
        got = tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam)
        torch.cuda.synchronize()
        want = tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        print(f"tx_codec vs plain sweep {tuple(frames.shape)} {b} Kbps "
              f"(pool factors {kcam.tolist()[:6]} per camera, masked/full "
              f"crops): max |diff| {err}")
        if not torch.equal(got, want):
            raise AssertionError("tx_codec differs from its plain version "
                                 "at the sweep's shape")
    return worst


class FitWatch:
    """Stands in for ``utility.fit`` while a profile runs: times each call,
    keeps its features, targets and fitted parameters, and on the card
    counts the host syncs inside it (``set_sync_debug_mode("warn")``,
    sites by file:line)."""

    def __init__(self, torch, util_mod):
        self.torch, self.util_mod, self.real = torch, util_mod, util_mod.fit
        self.calls = []

    def __enter__(self):
        self.util_mod.fit = self._fit
        return self

    def __exit__(self, *exc):
        self.util_mod.fit = self.real

    def _fit(self, params, features, targets, **kw):
        import collections
        import warnings
        import numpy as np
        torch = self.torch
        on_card = params["w1"].device.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                out = self.real(params, features, targets, **kw)
                wall = time.perf_counter() - t0   # the loss fetch waited
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
        syncs = collections.Counter(
            f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message))
        self.calls.append({
            "features": np.array(features), "targets": np.array(targets),
            "params": {k: v.detach().cpu() for k, v in out[0].items()},
            "loss": out[1], "ms": wall * 1e3, "steps": kw["steps"],
            "syncs": syncs})
        return out


def profile_phase(torch, dev, light_h, server_h, reset_counts, read_counts,
                  tag: str):
    """The offline profile at full width (``SystemConfig(eval_frames=5)``,
    C = 5, 96 x 160, 10 frames, 6 bitrates, 3 resolutions) on
    ``MultiCameraScene(SceneConfig(seed=42))`` for 8 slots and 700 fit
    steps: its artifacts, the sweep's ms per slot, the fit's ms per step,
    the launches of each kernel (B1 8, cc_label 8, B2 48, B3 0) and the
    host syncs inside the fit (1, the final loss).  Then 2 slots and 120
    steps on the card and on the CPU: features, targets and the jcab table
    to <= 1e-5, thresholds and sample counts equal, fitted parameters to
    <= FIT_TOL.  Returns (the profiled card system, its B2 sweep launches
    per kernel)."""
    import numpy as np
    from repro_torch.core import utility as util_mod
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.data.synthetic import MultiCameraScene, SceneConfig

    def system(device):
        return DeepStreamSystem(SystemConfig(eval_frames=5), light_h,
                                server_h, device=device)

    with FitWatch(torch, util_mod) as watch:
        s = system(dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = s.profile(MultiCameraScene(SceneConfig(seed=42)),
                         num_slots=PROFILE_SLOTS, mlp_steps=PROFILE_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n = read_counts()
        fit = watch.calls[-1]
        sweep_ms = (wall - fit["ms"]) / PROFILE_SLOTS
        print(f"profile C=5 {PROFILE_SLOTS} slots, {PROFILE_STEPS} fit steps: "
              f"mlp_mse {info['mlp_mse']:.6g}, tau_wl {info['tau_wl']}, "
              f"tau_wh {info['tau_wh']}, num_samples {info['num_samples']}")
        print("profile jcab table (J x R, bitrates x resolutions): "
              + json.dumps(np.round(s.jcab_table.astype(float), 4).tolist()))
        print(f"profile times: sweep {sweep_ms:.1f} ms/slot (scene, upload, "
              f"ROIDet, 6 fleet calls of 30 entries, fetches), fit "
              f"{fit['ms'] / PROFILE_STEPS:.3f} ms/step ({fit['ms']:.0f} ms "
              f"for {PROFILE_STEPS}), whole profile {wall:.0f} ms {tag}")
        print("profile launches: " + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; host syncs in fit {sum(fit['syncs'].values())} "
              f"{dict(fit['syncs'])}")
        want = {"edge_motion": PROFILE_SLOTS, "cc_label": PROFILE_SLOTS,
                "tx_codec": 6 * PROFILE_SLOTS, "knapsack_dp": 0,
                "flash_decode": 0}
        if n != want:
            raise AssertionError(f"profile launched {n}, not {want}")
        if sum(fit["syncs"].values()) != 1:
            raise AssertionError(f"fit waited on the card "
                                 f"{dict(fit['syncs'])} times, not once")
        if info["num_samples"] != PROFILE_SLOTS * 5 * 6 * 3:
            raise AssertionError("profile sample count")
        sweep_breakdown(torch, s, tag)
        arts = []
        for device in (dev, "cpu"):
            p = system(device)
            p.profile(MultiCameraScene(SceneConfig(seed=42)),
                      num_slots=PROFILE_CPU_SLOTS,
                      mlp_steps=PROFILE_CPU_STEPS)
            arts.append((p, watch.calls[-1]))
    (card, fc), (cpu, fh) = arts
    d = {"features": float(np.abs(fc["features"] - fh["features"]).max()),
         "targets": float(np.abs(fc["targets"] - fh["targets"]).max()),
         "jcab_table": float(np.abs(card.jcab_table - cpu.jcab_table).max()),
         "params": max(float((fc["params"][k] - fh["params"][k]).abs().max())
                       for k in fc["params"])}
    print(f"profile card vs CPU ({PROFILE_CPU_SLOTS} slots, "
          f"{PROFILE_CPU_STEPS} steps): max |diff| "
          + " ".join(f"{k} {v:.3g}" for k, v in d.items())
          + f"; tau card ({card.tau_wl}, {card.tau_wh}) CPU ({cpu.tau_wl}, "
          f"{cpu.tau_wh}); samples {len(fc['targets'])} / "
          f"{len(fh['targets'])}")
    if not (d["features"] <= 1e-5 and d["targets"] <= 1e-5
            and d["jcab_table"] <= 1e-5 and d["params"] <= FIT_TOL):
        raise AssertionError("the card's profile differs from the CPU's")
    if (card.tau_wl, card.tau_wh) != (cpu.tau_wl, cpu.tau_wh) or \
            fc["features"].shape != fh["features"].shape:
        raise AssertionError("the card's thresholds or samples differ")
    return s, n


def sweep_breakdown(torch, s, tag: str) -> None:
    """Where a sweep slot's time goes: its parts run alone once each on a
    fresh segment (host clock for the numpy scene, CUDA events around the
    rest, each ending in a fetch).  The system's key is restored
    afterwards."""
    from repro_torch.data.synthetic import MultiCameraScene, SceneConfig
    cfgc = s.cfg.codec
    n_keys = (s.cfg.scene.num_cameras * len(cfgc.bitrates_kbps)
              * len(cfgc.resolutions) * 2)
    key = s._key.clone()
    t0 = time.perf_counter()
    seg = MultiCameraScene(SceneConfig(seed=42)).segment()
    scene_ms = (time.perf_counter() - t0) * 1e3
    got = {}

    def roidet():
        got["frames"] = s._frames_of(seg)
        got["roi"] = s.camera_features(got["frames"])
        got["roi"].area_ratio.cpu()

    def chain():
        s._keys(n_keys).cpu()

    def sweep():    # the key chain, then one fleet call per bitrate
        s._profile_slot_batched(seg, got["frames"], got["roi"])

    roidet_ms, chain_ms, sweep_ms = (event_ms(torch, f)
                                     for f in (roidet, chain, sweep))
    s._key = key
    fleet_ms = (sweep_ms - chain_ms) / len(cfgc.bitrates_kbps)
    print(f"profile slot breakdown: numpy scene {scene_ms:.1f} ms, upload + "
          f"ROIDet + fetch {roidet_ms:.1f} ms, key chain ({n_keys} splits) "
          f"{chain_ms:.1f} ms, one fleet call of 30 entries with its fetch "
          f"{fleet_ms:.1f} ms (x {len(cfgc.bitrates_kbps)}) {tag}")


def artifacts_of(system) -> dict:
    """A profiled system's control artifacts, on the host."""
    return {"mlp": {k: v.detach().cpu() for k, v in system.mlp.items()},
            "tau": (system.tau_wl, system.tau_wh),
            "jcab_table": system.jcab_table.copy()}


def give_artifacts(system, arts: dict, num_cams: int = 5):
    """Hand profiled artifacts to ``system`` (the MLP on its device, the
    thresholds scaled from the 5 profiled cameras to ``num_cams``)."""
    system.mlp = {k: v.to(system.device) for k, v in arts["mlp"].items()}
    system.tau_wl, system.tau_wh = (t * num_cams / 5 for t in arts["tau"])
    system.jcab_table = arts["jcab_table"].copy()
    return system


def fig3_phase(torch, s, cpu_sys, reset_counts, read_counts, tag: str):
    """Fig. 3 on the card: the pipelined ``run()`` of the five methods on
    ``MultiCameraScene(SceneConfig(seed=77))`` over
    ``bandwidth_trace(kind, 16, seed=3)`` for each kind, with uniform and
    with the paper's weights, from the full profile's artifacts.  Gates:
    finite logs; B3 once per slot for the methods that solve the DP; the
    medium trace's first 4 slots equal the CPU ``run()`` holding the same
    artifacts (<= 1e-5).  Prints mean utility per cell and deepstream's
    gain over the best baseline (not a gate).  Returns the table."""
    import numpy as np
    from repro_torch.data.synthetic import (MultiCameraScene, SceneConfig,
                                            bandwidth_trace)
    table = {}
    for wname, weights in (("uniform", None), ("paper", PAPER_WEIGHTS)):
        for system in (s, cpu_sys):
            system.cfg.weights = (None if weights is None
                                  else np.asarray(weights))
        for kind in ("low", "medium", "high"):
            trace = bandwidth_trace(kind, FIG3_SLOTS, seed=3)
            row = {}
            for method in FIG3_METHODS:
                reset_counts()
                logs = s.run(MultiCameraScene(SceneConfig(seed=77)), trace,
                             method)
                n = read_counts()
                check_logs(logs, f"fig3 {wname} {kind} {method}")
                dp = FIG3_SLOTS if method in ("deepstream",
                                              "deepstream_no_elastic",
                                              "jcab") else 0
                if n["knapsack_dp"] != dp:
                    raise AssertionError(f"fig3 {method}: knapsack_dp "
                                         f"launched {n['knapsack_dp']} times,"
                                         f" not {dp}")
                row[method] = float(np.mean(logs["utility"]))
                if kind == "medium":
                    cpu_logs = cpu_sys.run(
                        MultiCameraScene(SceneConfig(seed=77)),
                        trace[:FIG3_CPU_SLOTS], method)
                    diffs = max_log_diff(
                        cpu_logs, {k: v[:FIG3_CPU_SLOTS]
                                   for k, v in logs.items()}, LOG_KEYS, 1e-5)
                    print(f"fig3 {wname} medium {method}: card vs CPU run() "
                          f"first {FIG3_CPU_SLOTS} slots max diff "
                          + " ".join(f"{k}={v:.3g}"
                                     for k, v in diffs.items()))
            best = max(row["jcab"], row["reducto"], row["static"])
            gain = row["deepstream"] / best - 1
            table[f"{wname}/{kind}"] = dict(row, gain=gain)
            print(f"fig3 {wname:7s} {kind:6s}: "
                  + " ".join(f"{m}={row[m]:.4f}" for m in FIG3_METHODS)
                  + f" | deepstream vs best baseline {100 * gain:+.2f}% {tag}")
    for system in (s, cpu_sys):
        system.cfg.weights = None
    return table


def control_scan_phase(torch, dev, s, reset_counts, read_counts) -> None:
    """``fleet_control_scan`` over 16 slots of deepstream control on the
    card (seeded features, the medium trace, the profiled artifacts):
    equal to 16 ``fleet_control_step`` calls bitwise, no host sync
    (``set_sync_debug_mode("error")``), knapsack_dp launched 16 times."""
    import numpy as np
    from repro_torch.common.device import upload
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.data.synthetic import bandwidth_trace
    T, C = FIG3_SLOTS, s.cfg.scene.num_cameras
    r = np.random.default_rng(12)
    a = upload(r.uniform(0.0, 0.6, (T, C)), dev, np.float32)
    c = upload(r.uniform(0.2, 1.0, (T, C)), dev, np.float32)
    trace = bandwidth_trace("medium", T, seed=3)
    ctx = s._control_context("deepstream", trace, True)
    cfgc = s.cfg.codec
    statics = dict(method="deepstream", ecfg=s.cfg.elastic,
                   bitrates=tuple(cfgc.bitrates_kbps),
                   resolutions=tuple(cfgc.resolutions),
                   slot_seconds=cfgc.slot_seconds, use_elastic=True,
                   w_cap=ctx["w_cap"], num_cams=C, tables=s._tables)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b, rr, packs, est = fleet_mod.fleet_control_scan(
            s.mlp, None, None, ctx["lam"], a, c, ctx["trace"], ctx["est"],
            ctx["tau_wl"], ctx["tau_wh"], **statics)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n = read_counts()
    if n["knapsack_dp"] != T:
        raise AssertionError(f"fleet_control_scan launched knapsack_dp "
                             f"{n['knapsack_dp']} times, not {T}")
    est_s = ctx["est"]
    live = torch.ones((C,), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    for t in range(T):
        co = fleet_mod.fleet_control_step(
            s.mlp, None, None, ctx["lam"], a[t], c[t], ctx["trace"][t],
            est_s, ctx["tau_wl"], ctx["tau_wh"], live, no, **statics)
        est_s = co.est
        if not (torch.equal(co.b, b[t]) and torch.equal(co.r, rr[t])
                and torch.equal(co.pack, packs[t])):
            raise AssertionError(f"fleet_control_scan differs from the step "
                                 f"loop at slot {t}")
    if not all(torch.equal(x, y) for x, y in zip(est, est_s)):
        raise AssertionError("fleet_control_scan's final state differs")
    borrowed = float(packs[:, 0].clamp(min=0).sum())
    print(f"fleet_control_scan deepstream C={C} T={T}: equal to {T} "
          f"fleet_control_step calls bitwise (b, r, packs, state); no host "
          f"sync under set_sync_debug_mode('error'); knapsack_dp "
          f"{n['knapsack_dp']} launches; {borrowed:.1f} Kbps borrowed in all")


# -- crash-safe fleet serving (slice 8) ------------------------------------

STREAM_SLOTS = 64        # make_soak_stream(64): 8 windows of 8
STREAM_WINDOW = 8
STREAM_CPU_SLOTS = 16    # the windowed stream held to the port's CPU stream
SUPERVISOR_SLOTS = 8     # the supervised run (two chunks of 4 when degraded)
STREAM_C_WIDE = 16       # the second width the stream is timed at


class _InjectedCrash(Exception):
    """The kill-and-resume check's crash."""


def shadow_kernels(torch, s, trace, live, methods, needs) -> dict:
    """Each kernel of the stream path against its plain version on the
    inputs the path gives it: one window per method run eagerly on the
    card with every kernel dispatcher wrapped, so that each launch is
    repeated by the same dispatcher on CPU copies of its arguments (the
    plain version) and compared bitwise (knapsack_dp: picks and total).
    Returns {kernel: (calls, worst |diff|)}."""
    from repro_torch.data.synthetic import DeviceScene
    from repro_torch.kernels.cc_label import ops as cc_ops
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.tx_codec import ops as tx_ops
    seen = {}
    cpu = lambda x: x.cpu() if torch.is_tensor(x) else x  # noqa: E731

    def wrap(mod, attr, name):
        orig = getattr(mod, attr)

        def shadow(*a, **kw):
            got = orig(*a, **kw)
            want = orig(*map(cpu, a), **{k: cpu(v) for k, v in kw.items()})
            pairs = zip(got, want) if isinstance(got, tuple) else [(got,
                                                                    want)]
            err = 0.0
            for g, w in pairs:
                g = g.cpu()
                if not torch.equal(g, w):
                    raise AssertionError(f"stream path: {name} differs from "
                                         f"its plain version")
                err = max(err, float((g.double() - w.double()).abs().max()))
            n, worst = seen.get(name, (0, 0.0))
            seen[name] = (n + 1, max(worst, err))
            return got
        setattr(mod, attr, shadow)
        return mod, attr, orig

    patched = [wrap(em_ops, "segment_motion_fleet", "edge_motion"),
               wrap(tx_ops, "tx_codec", "tx_codec"),
               wrap(dp_ops, "solve_device", "knapsack_dp"),
               wrap(cc_ops, "cc_label", "cc_label")]
    try:
        for method in methods:
            seen_before = {k: v[0] for k, v in seen.items()}
            scene = DeviceScene(s.cfg.scene, device=s.device)
            s._episode_logs(s._episode_dispatch(
                scene, trace, method, faults=live, _eager=True), trace)
            for k in needs(method):
                if seen.get(k, (0, 0.0))[0] == seen_before.get(k, 0):
                    raise AssertionError(f"stream {method}: {k} not launched "
                                         "on the eager window")
    finally:
        for mod, attr, orig in patched:
            setattr(mod, attr, orig)
    return seen


def stream_phase(torch, dev, light_h, server_h, arts, reset_counts,
                 read_counts, needs, tag) -> tuple:
    """Crash-safe fleet serving on the card (``serve.stream``) at the
    fleet's full width: ``SystemConfig()`` defaults (5 cameras, 96 x 160,
    10 frames, block 8) in episode mode with the capacity pinned at 8000
    Kbps (scaled by C/5), the committed detectors, the profiled artifacts,
    ``make_soak_stream(64, num_cams=5)`` in windows of 8.  Checks: each
    method's windowed logs against one ``run_episode`` over the stream
    (and deepstream's first 16 slots against the port's CPU stream); each
    kernel of the path against its plain version on the path's inputs;
    kill-and-resume (deepstream: a crash before window 3; reducto: the
    same with the newest generation bit-flipped) with no graph captured
    after the restore; the
    ladder down to the slot loop and back; ``EpisodeSupervisor`` against
    the CPU's; the checked lane (bitwise equal to the unchecked lane in
    episode and pipelined mode, no host sync before the harvest, a NaN slot
    raising at the harvest); the launcher run twice.  Times: window
    turnaround, slots/s, the checkpoint's snapshot, write and restore, and
    host syncs per window by site, at C=5 (four methods) and C=16.
    Returns (per-method runners for the CUPTI count of one window's
    launches in phase 9, the kernels' worst |diff| on the path)."""
    import collections
    import os
    import shutil
    import warnings
    import numpy as np
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.core.scheduler import (DeepStreamSystem,
                                            EpisodeSupervisor,
                                            SupervisorConfig, SystemConfig)
    from repro_torch.data.scenarios import make_soak_stream
    from repro_torch.data.synthetic import DeviceScene, SceneConfig
    from repro_torch.ft.chaos import ChaosEngine
    from repro_torch.ft.watchdog import WatchdogConfig
    from repro_torch.serve.stream import StreamConfig, StreamingFleetRunner

    work = ROOT / "build" / "stream"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    W = STREAM_WINDOW

    def system(C=5, device=dev, **kw):
        kw.setdefault("episode", True)
        cfg = SystemConfig(scene=SceneConfig(num_cameras=C),
                           w_cap_kbps=8000.0 * C / 5, **kw)
        return give_artifacts(DeepStreamSystem(cfg, light_h, server_h,
                                               device=device), arts, C)

    def runner(s, method, cfg=None, **kw):
        return StreamingFleetRunner(
            s, DeviceScene(s.cfg.scene, device=s.device), method=method,
            cfg=cfg or StreamConfig(window_slots=W, queue_slots=STREAM_SLOTS),
            **kw)

    def logs_of(r):
        return {k: np.asarray(v) for k, v in r.logs.items()}

    def serve_all(r, trace, live):
        assert r.offer(trace, faults=live) == len(trace)
        r.serve(flush=True)
        return logs_of(r)

    def bitwise(a, b) -> bool:
        return all(np.array_equal(a[k], b[k]) for k in LOG_KEYS)

    trace, live = make_soak_stream(STREAM_SLOTS, num_cams=5)
    g = system()

    # 1. windowed = continuous, and the path's wrapper calls
    windowed, continuous = {}, {}
    for method in METHODS:
        reset_counts()
        windowed[method] = serve_all(runner(g, method), trace, live)
        n = read_counts()
        if any(n[k] == 0 for k in needs(method)):
            raise AssertionError(f"stream {method}: a kernel of the path "
                                 f"was launched no time {n}")
        check_logs(windowed[method], f"stream {method}")
        continuous[method] = g.run_episode(
            DeviceScene(g.cfg.scene, device=dev), trace, method, faults=live)
        d = max_log_diff(continuous[method], windowed[method], LOG_KEYS,
                         1e-5, "windowed vs continuous")
        same = bitwise(continuous[method], windowed[method])
        print(f"stream {method} C=5 T={STREAM_SLOTS} in windows of {W}: "
              "wrapper calls at capture "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; vs one run_episode {'' if same else 'not '}bitwise, "
              "max diff " + " ".join(f"{k}={v:.3g}" for k, v in d.items()))
    cpu_logs = serve_all(runner(system(device="cpu"), "deepstream"),
                         trace[:STREAM_CPU_SLOTS], live[:STREAM_CPU_SLOTS])
    d = max_log_diff(cpu_logs, {k: v[:STREAM_CPU_SLOTS] for k, v in
                                windowed["deepstream"].items()}, LOG_KEYS,
                     1e-5)
    print(f"stream deepstream: the first {STREAM_CPU_SLOTS} slots vs the "
          "port's CPU stream, max diff "
          + " ".join(f"{k}={v:.3g}" for k, v in d.items()))
    seen = shadow_kernels(torch, g, trace[:W], live[:W], METHODS, needs)
    print("stream kernels vs plain on the stream path's inputs (one eager "
          "window per method): " + "; ".join(
              f"{k} {n} calls, max |diff| {e}" for k, (n, e) in seen.items()))

    # 2. kill and resume: deepstream crashes before window 3; reducto
    # (whose carry holds the reference frames, nearly all of a
    # checkpoint's bytes) the same with the newest generation bit-flipped
    # after its commit
    from repro_torch.ckpt import checkpoint as ckpt
    for method, variant in (("deepstream", "crash"),
                            ("reducto", "crash + bitflip")):
        ref = windowed[method]
        d_ck = work / variant.replace(" + ", "_")
        eng = (ChaosEngine(0, {"ckpt.bitflip": {"at": [3]}})
               if "bitflip" in variant else None)

        def crash(window, rung):
            if window == 3:
                raise _InjectedCrash(f"window {window}")
        rA = runner(system(), method, StreamConfig(
            window_slots=W, queue_slots=STREAM_SLOTS, ckpt_dir=str(d_ck)),
            fault_hook=crash, chaos=eng)
        rA.offer(trace, faults=live)
        try:
            rA.serve(flush=True)
            raise AssertionError("the injected crash did not happen")
        except _InjectedCrash:
            pass
        rA.close()
        graphs = fleet_mod.episode_graph_count()
        newest = ckpt.latest_committed(d_ck)
        size = sum(f.stat().st_size for f in newest.glob("data.*.bin"))
        rB = runner(system(), method, StreamConfig(
            window_slots=W, queue_slots=STREAM_SLOTS, ckpt_dir=str(d_ck)))
        if not rB.restore():
            raise AssertionError(f"{variant}: nothing restored")
        skips = [e for e in rB.events if e["kind"] == "restore_skip"]
        want_t = 3 * W if eng is None else 2 * W
        if rB.t_next != want_t or len(skips) != (eng is not None):
            raise AssertionError(f"{variant}: restored t_next {rB.t_next}, "
                                 f"skipped {skips}")
        t0 = rB.t_next
        rB.offer(trace[t0:], faults=live[t0:])
        rB.serve(flush=True)
        rB.close()
        if fleet_mod.episode_graph_count() != graphs:
            raise AssertionError(f"{variant}: a graph was captured after "
                                 "the restore")
        got = logs_of(rB)
        d = max_log_diff(ref, got, LOG_KEYS, 1e-5, f"{variant} resume")
        print(f"stream kill-and-resume ({variant}) {method}: a checkpoint "
              f"of {size} bytes ({'zstd' if ckpt.HAVE_ZSTD else 'zlib'}); "
              f"crashed before window 3, restored t_next {t0}"
              + (f" (skipped the newest generation: {skips[0]['error']})"
                 if skips else "")
              + f" in {rB.restore_s[0] * 1e3:.2f} ms; 0 graphs captured "
              f"after the restore; vs the uninterrupted stream "
              f"{'bitwise' if bitwise(ref, got) else 'not bitwise'}, max "
              "diff " + " ".join(f"{k}={v:.3g}" for k, v in d.items()))

    # 3. the ladder: straggling walls take the runner down to the slot loop,
    # healthy ones bring it back; episode_small runs chunks of 4
    walls = {1: 6.0, 3: 6.0}
    rl = runner(system(episode_buckets=(4, 8, 16, 32)), "deepstream",
                StreamConfig(window_slots=W, queue_slots=STREAM_SLOTS,
                             recover_after=2,
                             watchdog=WatchdogConfig(warmup_steps=1,
                                                     escalate_after=1)),
                wall_hook=lambda w, wall: walls.get(w, 1.0))
    got = serve_all(rl, trace, live)
    moves = [(e["kind"], e["to"]) for e in rl.events
             if e["kind"] in ("degrade", "recover")]
    if moves != [("degrade", "episode_small"), ("degrade", "pipelined"),
                 ("recover", "episode_small"), ("recover", "episode")]:
        raise AssertionError(f"ladder: {moves}")
    rungs = [e["rung"] for e in rl.events if e["kind"] == "window"]
    d = max_log_diff(windowed["deepstream"], got, LOG_KEYS, 1e-5,
                     "ladder")
    print(f"stream ladder deepstream: rungs per window {rungs}; "
          f"{', '.join(f'{k} to {to}' for k, to in moves)}; vs the "
          "uninterrupted stream max diff "
          + " ".join(f"{k}={v:.3g}" for k, v in d.items()))

    # 4. the supervisor: retries, then the chunked rung; card vs CPU
    def supervised(s):
        def hook(attempt, mode):
            if mode == "episode":
                raise RuntimeError("injected dispatch failure")
        sup = EpisodeSupervisor(s, SupervisorConfig(max_retries=1),
                                fault_hook=hook)
        out = sup.run(DeviceScene(s.cfg.scene, device=s.device),
                      trace[:SUPERVISOR_SLOTS], "deepstream",
                      faults=live[:SUPERVISOR_SLOTS])
        return sup, out
    sup, got = supervised(system(episode_buckets=(4, 8, 16, 32)))
    sup_cpu, want = supervised(system(device="cpu",
                                      episode_buckets=(4, 8, 16, 32)))
    kinds = [(e["kind"], e["mode"]) for e in sup.events]
    if kinds != [(e["kind"], e["mode"]) for e in sup_cpu.events] or \
            sup.mode != "episode_chunked":
        raise AssertionError(f"supervisor: {kinds} on the card, "
                             f"{sup_cpu.events} on the CPU")
    d = max_log_diff(want, got, LOG_KEYS, 1e-5)
    print(f"supervisor deepstream T={SUPERVISOR_SLOTS}: {kinds}; chunks of "
          f"{sup._chunk_len(SUPERVISOR_SLOTS)}; card vs CPU max diff "
          + " ".join(f"{k}={v:.3g}" for k, v in d.items()))

    # 5. the checked lane
    tr, lv = trace[:W], live[:W]
    nan_tr = tr.copy()
    nan_tr[len(tr) // 2] = np.nan
    for mode, kw in (("episode", {}), ("pipelined", {"episode": False})):
        plain, chk = system(**kw), system(checked=True, **kw)
        a = plain.run(DeviceScene(plain.cfg.scene, device=dev), tr,
                      "deepstream", faults=lv)
        b = chk.run(DeviceScene(chk.cfg.scene, device=dev), tr,
                    "deepstream", faults=lv)
        if not bitwise(a, b):
            raise AssertionError(f"checked {mode} run differs from the "
                                 "unchecked run")
        syncs = "the pipelined loop reads each slot's flags at its harvest"
        if mode == "episode":
            scene = DeviceScene(chk.cfg.scene, device=dev)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = chk._episode_dispatch(scene, tr, "deepstream",
                                            faults=lv)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if not bitwise(a, chk._episode_logs(out, tr)):
                raise AssertionError("checked replay differs")
            syncs = "0 host syncs before the harvest"
        try:
            if mode == "episode":
                scene = DeviceScene(chk.cfg.scene, device=dev)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = chk._episode_dispatch(scene, nan_tr, "deepstream",
                                                faults=lv)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                chk._episode_logs(out, nan_tr)
            else:
                chk.run(DeviceScene(chk.cfg.scene, device=dev), nan_tr,
                        "deepstream", faults=lv)
            raise AssertionError(f"checked {mode}: a NaN slot did not "
                                 "raise")
        except fleet_mod.CheckError as e:
            msg = str(e)
        print(f"checked lane {mode} deepstream T={W}: bitwise equal to the "
              f"unchecked lane; {syncs}; a NaN slot raises at the harvest: "
              f"{msg!r}")

    # 6. the launcher, twice: the second run restores
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--fleet-stream",
           "--stream-slots", str(STREAM_SLOTS), "--window-slots", str(W),
           "--device", dev.type, "--ckpt-dir", str(work / "launcher")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for _ in range(2):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"launcher failed:\n{p.stdout}\n{p.stderr}")
        outs.append((time.perf_counter() - t0, p.stdout.strip().splitlines()))
    if f"# restored window={STREAM_SLOTS // W} t_next={STREAM_SLOTS}" \
            not in outs[1][1]:
        raise AssertionError(f"the launcher's second run did not restore: "
                             f"{outs[1][1]}")
    for i, (sec, lines) in enumerate(outs):
        print(f"launcher run {i + 1} ({sec:.1f} s): " + " | ".join(lines))

    # 7. times: window turnaround, the checkpoint's costs, syncs per window
    def sync_sites(fn) -> collections.Counter:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return collections.Counter(
            "checkpoint" if Path(w.filename).name == "checkpoint.py" else
            "harvest" if Path(w.filename).name == "scheduler.py" else
            f"{Path(w.filename).name}:{w.lineno}" for w in caught)

    window_runners = {}
    for C, methods in ((5, METHODS), (STREAM_C_WIDE, ("deepstream",))):
        s = g if C == 5 else system(C)
        tr_c, lv_c = make_soak_stream(STREAM_SLOTS, num_cams=C)
        for method in methods:
            if C != 5:    # capture this configuration's graphs first
                serve_all(runner(s, method), tr_c[:W], lv_c[:W])
            d_t = work / f"timing_C{C}_{method}"
            cfg = StreamConfig(window_slots=W, queue_slots=STREAM_SLOTS,
                               ckpt_dir=str(d_t))
            r = runner(s, method, cfg)
            serve_all(r, tr_c, lv_c)
            r.close()
            st = r.stats()
            rr = runner(s, method, cfg)
            rr.restore()
            sites = sync_sites(lambda: (rr.offer(tr_c[:W], faults=lv_c[:W]),
                                        rr.serve(), rr.close()))
            # (the CPU rehearsal records no syncs)
            if dev.type == "cuda" and (set(sites) - {"harvest",
                                                     "checkpoint"}
                                       or sites["checkpoint"] != 1):
                raise AssertionError(f"stream {method} C={C}: host syncs "
                                     f"{dict(sites)}")
            print(f"stream C={C} method={method}: {st['windows']} windows of "
                  f"{W}; window turnaround p50 {st['p50_window_s'] * 1e3:.2f}"
                  f" ms, p99 {st['p99_window_s'] * 1e3:.2f} ms; "
                  f"{st['slots_per_s']:.1f} slots/s; checkpoint snapshot "
                  f"{st['ckpt_snapshot_ms']:.3f} ms, async write "
                  f"{st['ckpt_write_ms']:.3f} ms, restore "
                  f"{rr.stats()['restore_ms']:.3f} ms; host syncs per "
                  f"window: harvest {sites['harvest']}, checkpoint "
                  f"{sites['checkpoint']} {tag}")
            if C == 5:
                window_runners[method] = (runner(s, method), trace, live)
    return window_runners, {k: e for k, (_, e) in seen.items()}


def stream_window(runner, trace, live) -> None:
    """Serve the next window of the stream (the trace taken cyclically)."""
    i = runner.t_next % len(trace)
    runner.offer(trace[i:i + STREAM_WINDOW], faults=live[i:i + STREAM_WINDOW])
    runner.serve()


# -- 10. training --------------------------------------------------------------
TRAIN_LIGHT = dict(steps=8, batch=4)      # (a): card vs the port's CPU
TRAIN_SERVER = dict(steps=600, batch=12)  # (b): tests/harness.py:112
DET_LOSS_RTOL = 1e-5     # (a): each step's loss, card vs CPU
DET_PARAM_TOL = 1e-5     # (a): weights after 8 steps, / max(|w|, 1e-3) a leaf
UTILITY_DROP = 0.05      # (b): the card-trained server detector's mean
                         # utility per camera (F1) below the committed one's
LM_TRAIN_LAYERS = 8      # (c): of granite-8b's 36 (the AdamW state of 36
LM_TRAIN_ROWS = 4        # layers does not fit in 80 GB); rows of 4096 tokens
LM_TRAIN_SEQ = 4096      # (train_4k: 256 rows)
LM_MB_RTOL = 1e-2        # (c): microbatched loss vs the single step's (bf16)
LM_TIMED = 5             # (c): timed steps after one warm-up


def recorded_losses(dt) -> tuple:
    """(losses, wrapper): ``detector_train.value_and_grad`` that keeps each
    step's loss tensor (no host read)."""
    losses = []
    plain = dt.value_and_grad

    def wrapper(*args):
        out = plain(*args)
        losses.append(out[0])
        return out
    return losses, wrapper


def train_phase(torch, dev, tag: str, reset_counts, read_counts,
                system_with, scene_of, trace, committed_logs,
                episode_want: dict) -> dict:
    """The training path on the card: (a) the light detector trained on
    the card and on the port's CPU, step by step; (b) the server detector
    at the harness's settings, timed, with no host sync in its loop, then
    put into the graph-replayed deepstream episode; (c) granite-8b at its
    published width and 8 layers: loss falling on a fixed batch, the
    microbatched step against the single step's loss, then timed steps on
    the loader's batches; (d) the launcher, twice.  Every launch counter
    is 0 after the trainers.  Returns the launch counts."""
    import collections
    import os
    import shutil
    import warnings
    from unittest import mock
    import numpy as np
    from repro_torch.common.config import OptimizerConfig, RunConfig
    from repro_torch.common.convert import params_to_numpy
    from repro_torch.common.params import param_count
    from repro_torch.configs import get_config
    from repro_torch.configs import granite_8b
    from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                           SyntheticTokenSource)
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models.model import LM
    from repro_torch.train import detector_train as dt
    from repro_torch.train.steps import init_train_state, make_train_step

    reset_counts()
    # (a) the light detector, card vs the port's CPU
    runs = {}
    for where in ("cpu", dev):
        losses, wrapper = recorded_losses(dt)
        with mock.patch.object(dt, "value_and_grad", wrapper):
            params = dt.train_detector("light", seed=0, cache=False,
                                       device=where, **TRAIN_LIGHT)
        runs[str(where)] = (torch.stack(losses).cpu().numpy(),
                            params_to_numpy(params, "detector"))
    (cl, cp), (gl, gp) = runs["cpu"], runs[str(dev)]
    loss_err = float(np.max(np.abs(gl - cl) / np.abs(cl)))
    param_err = max(float(np.abs(gp[k] - cp[k]).max())
                    / max(float(np.abs(cp[k]).max()), 1e-3) for k in cp)
    print(f"train light detector card vs CPU ({TRAIN_LIGHT['steps']} steps, "
          f"batch {TRAIN_LIGHT['batch']}, seed 0): losses "
          f"{[round(float(x), 6) for x in gl]}; max relative loss diff "
          f"{loss_err:.3g} (limit {DET_LOSS_RTOL}); weights max |diff| / "
          f"max |w| {param_err:.3g} (limit {DET_PARAM_TOL})")
    if not (loss_err <= DET_LOSS_RTOL and param_err <= DET_PARAM_TOL):
        raise AssertionError("the card's detector training differs from "
                             "the CPU's")

    # (b) the server detector at the harness's settings
    losses, wrapper = recorded_losses(dt)
    plain_batch = dt.make_training_batch
    scene_s, first = [], []

    def timed_batch(*args, **kw):
        if not first:
            first.append(len(caught))   # the loop starts here
        t0 = time.perf_counter()
        out = plain_batch(*args, **kw)
        scene_s.append(time.perf_counter() - t0)
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught, \
            mock.patch.object(dt, "value_and_grad", wrapper), \
            mock.patch.object(dt, "make_training_batch", timed_batch):
        warnings.simplefilter("always")
        start.record()
        server = dt.train_detector("server", seed=0, cache=False, device=dev,
                                   **TRAIN_SERVER)
        end.record()
        torch.cuda.set_sync_debug_mode("default")
    end.synchronize()
    in_loop = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                  for w in caught[first[0]:])
    total_ms = start.elapsed_time(end)
    steps = TRAIN_SERVER["steps"]
    final = float(losses[-1])
    committed = json.loads((ROOT / "artifacts" / "detector_server" /
                            "manifest.json").read_text())["metadata"]["loss"]
    print(f"train server detector ({steps} steps, batch "
          f"{TRAIN_SERVER['batch']}, seed 0, 96 x 160): "
          f"{total_ms / steps:.3f} ms/step (CUDA events around the call), "
          f"{100 * sum(scene_s) * 1e3 / total_ms:.1f}% of it in the numpy "
          f"scene ({sum(scene_s) * 1e3 / steps:.3f} ms/step); host syncs in "
          f"the loop {sum(in_loop.values())} {dict(in_loop)}; final loss "
          f"{final:.4f} (the committed JAX checkpoint's {committed:.4f}) "
          f"{tag}")
    if in_loop:
        raise AssertionError("the detector's training loop waits on the "
                             "card")
    if any(read_counts().values()):
        raise AssertionError(f"a detector trainer launched a hand-written "
                             f"kernel {read_counts()}")
    t_sys = system_with(server)
    logs = t_sys.run_episode(scene_of(t_sys), trace, "deepstream")
    check_logs(logs, "episode deepstream, card-trained server detector")
    # a camera's utility is its F1; "utility" is their lambda-weighted sum
    # over the 5 cameras, so the limit holds the per-camera mean
    got_u = float(np.mean(logs["mean_f1"]))
    want_u = float(np.mean(committed_logs["mean_f1"]))
    got_sum = float(np.mean(logs["utility"]))
    want_sum = float(np.mean(committed_logs["utility"]))
    reset_counts()
    ep_launches = recorded_launches(
        torch, lambda: t_sys.run_episode(scene_of(t_sys), trace,
                                         "deepstream"),
        episode_want, "episode deepstream (card-trained server)")
    print(f"episode deepstream C=5 T={len(trace)} graph-replayed with the "
          f"card-trained server detector: mean utility per camera (F1) "
          f"{got_u:.4f} vs {want_u:.4f} with the committed weights (limit: "
          f"{UTILITY_DROP} below), summed over the cameras {got_sum:.4f} vs "
          f"{want_sum:.4f}; kernels the card ran (CUPTI) "
          + " ".join(f"{k} {v}" for k, v in ep_launches.items()))
    if got_u < want_u - UTILITY_DROP:
        raise AssertionError("the card-trained server detector loses "
                             "utility")
    del server, t_sys

    # (c) granite-8b at its published width, LM_TRAIN_LAYERS layers
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("granite-8b").replace(num_layers=LM_TRAIN_LAYERS)
    run = RunConfig(model=cfg, opt=OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=100,
        moment_dtype=granite_8b.MOMENT_DTYPE),
        microbatches=granite_8b.MICROBATCHES["train_4k"])
    lm = LM(cfg)
    t0 = time.perf_counter()
    params, opt = init_train_state(lm, run, torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    RECORDED["allocated"][("granite-8b", "train", cfg.num_layers)] = {
        "weights_bytes": tree_bytes(params), "adamw_bytes": tree_bytes(opt)}
    n_params = param_count(lm.param_defs())
    step = make_train_step(lm, run, donate=True)
    src = SyntheticTokenSource(DataConfig(LM_TRAIN_ROWS, LM_TRAIN_SEQ,
                                          cfg.vocab_size))
    fixed = {k: torch.as_tensor(v, device=dev)
             for k, v in src.batch_at(0).items()}
    with torch.no_grad():      # the single step's loss: one forward of
        single = float(lm.loss(params, fixed)[0])   # all 4 rows
    curve = []
    for _ in range(3):
        params, opt, m = step(params, opt, fixed)
        curve.append(m["loss"])
    with torch.no_grad():
        curve.append(lm.loss(params, fixed)[0])
    curve = torch.stack(curve).tolist()
    mb_err = abs(curve[0] - single) / abs(single)
    print(f"granite-8b train ({LM_TRAIN_LAYERS} of 36 layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params:,} parameters, "
          f"bf16 weights, float32 moments, remat {cfg.remat_policy}, "
          f"{run.microbatches} microbatches; init {init_s:.2f} s): fixed "
          f"batch ({LM_TRAIN_ROWS} x {LM_TRAIN_SEQ}) loss before each of 3 "
          f"steps and after: {[round(x, 4) for x in curve]}; the "
          f"microbatched step's loss {curve[0]:.5f} vs the single step's "
          f"{single:.5f} (relative {mb_err:.3g}, limit {LM_MB_RTOL}) {tag}")
    if not all(b < a for a, b in zip(curve, curve[1:])):
        raise AssertionError("granite-8b: 3 steps did not lower the loss")
    if not mb_err <= LM_MB_RTOL:
        raise AssertionError("granite-8b: the microbatched step's loss "
                             "differs from the single step's")
    loader = PrefetchLoader(src, dev)
    it = iter(loader)
    params, opt, m = step(params, opt, next(it))     # warm-up
    ms = []
    for _ in range(LM_TIMED):
        batch = next(it)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    from torch.autograd import DeviceType
    batch = next(it)
    torch.cuda.synchronize()
    with profiler(torch, "granite-8b's profiled train step") as prof:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(0.05)    # the card's activity records arrive late
    loader.close()
    busy = device_us(prof) / 1e3
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    med = statistics.median(ms)
    RECORDED["measured"]["granite-8b train"] = med
    tokens = LM_TRAIN_ROWS * LM_TRAIN_SEQ
    # 6 N per token for the matrices (the embedding lookup does none) and
    # 12 L H hd S per token for attention (PaLM's count, no causal halving)
    n_matmul = n_params - cfg.padded_vocab * cfg.d_model
    flops = tokens * (6 * n_matmul + 12 * cfg.num_layers * cfg.num_heads
                      * cfg.resolved_head_dim * LM_TRAIN_SEQ)
    mfu = mfu_text(cfg, LM_TRAIN_ROWS, LM_TRAIN_SEQ, run.microbatches,
                   flops, med)
    print(f"granite-8b train step on the loader's batches: median "
          f"{med:.1f} ms (min {min(ms):.1f}, max {max(ms):.1f}, {LM_TIMED} "
          f"steps after a warm-up, CUDA events); {tokens / med * 1e3:,.0f} "
          f"tokens/s; {mfu}; peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} bytes); last loss "
          f"{float(m['loss']):.4f} {tag}")
    print(f"granite-8b one profiled train step: wall {wall:.1f} ms, "
          f"{n_kernels} kernels on the card taking {busy:.1f} ms "
          f"({100 * busy / wall:.1f}% busy) {tag}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12))
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"the LM trainer launched a hand-written kernel "
                             f"{counts}")
    del params, opt, m, fixed, batch, prof
    torch.cuda.empty_cache()

    # (d) the launcher, twice: the second run resumes
    work = ROOT / "build" / "train"
    if work.exists():
        shutil.rmtree(work)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = []
    for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "granite-8b", "--smoke", "--device", dev.type, "--ckpt-dir",
               str(work)] + extra
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"launcher failed:\n{p.stdout}\n{p.stderr}")
        outs.append((time.perf_counter() - t0, p.stdout.strip().splitlines()))
    want = f"resumed from {work / 'step_00000004'} at step 4"
    if outs[1][1][0] != want:
        raise AssertionError(f"the launcher's second run did not resume: "
                             f"{outs[1][1]}")
    for i, (sec, lines) in enumerate(outs):
        print(f"train launcher run {i + 1} ({sec:.1f} s): "
              + " | ".join(lines))
    return {"train": 0, "train_episode": ep_launches}

# -- 12. the static audit, the dry run, the quickstart, the roofline -------

# (arch, shape cell, kind of the phase's run, depth it ran at, why): each
# `reduced` line of phases 10 and 11 and the dry run of its model
DRYRUN_CUTS = (
    ("granite-8b", "train_4k", "train", LM_TRAIN_LAYERS,
     "the AdamW state of 36 layers does not fit (phase 10)"),
    ("olmoe-1b-7b", "train_4k", "train", 4, FAM_CUTS[("train",
                                                      "olmoe-1b-7b")]),
    ("llama-3.2-vision-90b", "decode_32k", "serve", 10,
     FAM_CUTS[("serve", "llama-3.2-vision-90b")]),
    ("xlstm-125m", "train_4k", "train", None,
     FAM_CUTS[("train", "xlstm-125m")] + " (rows: activations, which the "
     "dry run does not model)"))


def audit_phase(torch, dev, tag: str, system, trace, phase4_keys) -> None:
    """Phase 12, no profiler: the host-sync lint over the port (0
    findings); the graph audit on the card (every registered program of
    the canonical deployment run once under ``NoHostReads``, the matrix
    count, two harvests per episode, the key ops at C=5 and 9); every key
    phase 4 captured at C=5 a registry entry of that configuration, with
    its four graphs, and
    ``slot_camera_keys`` runs the same aten ops at C=5 and 16 on the
    card); the dry run beside each cut (the weights and AdamW state the
    phases allocated equal the dry run's at the cut depth, to the byte);
    ``examples/quickstart_torch.py`` on the card (its slot launches B1,
    B2, B3 and cc_label); and the roofline's one-card terms for
    granite-8b's train step and decode beside their measured ms."""
    import importlib.util
    from repro_torch.analysis import graph_audit, lint
    from repro_torch.analysis.programs import (Canonical, canonical_system,
                                               get_programs, graph_names)
    from repro_torch.common.config import H100_SXM, ShapeCell
    from repro_torch.configs import get_config
    from repro_torch.core import fleet
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analytic import MeshDims, analytic_terms

    findings = lint.lint_tree()
    print(f"lint (python -m repro_torch.analysis.lint): {len(findings)} "
          f"findings over {len(lint.TRACED_SCOPES)} registered files")
    for f in findings:
        print(f"  {f}")
    if findings:
        raise AssertionError("the port's registered scopes do not lint "
                             "clean")

    t0 = time.perf_counter()
    registry = get_programs(canon=Canonical(canonical_system(dev)))
    failures = graph_audit.audit(registry, device=dev)
    for f in failures:
        print(f"  FAIL {f}")
    if failures:
        raise AssertionError("the graph audit fails on the card")
    print(f"graph audit on the card (python -m repro_torch.analysis."
          f"graph_audit): {len(registry)} programs of the canonical "
          f"deployment (C={registry[0].statics.num_cams}), each run once "
          f"under NoHostReads: no host read; "
          f"{sum(p.kind == 'episode' for p in registry)} episode programs, "
          f"two harvests each; key ops at C=5 = C=9 "
          f"({time.perf_counter() - t0:.1f} s)")

    progs = get_programs(kinds=["episode"], canon=Canonical(system, trace),
                         methods=EP_METHODS)
    entries = {(p.statics, tuple((tuple(t.shape), t.dtype)
                                 for t in p.inputs.values())): p
               for p in progs}
    matched = []
    for key in phase4_keys:
        prog = entries.get((key[0], tuple((tuple(sh), dt)
                                          for sh, dt in key[2:])))
        if prog is None:
            raise AssertionError(f"phase 4 captured a graph key the "
                                 f"registry has no entry for: {key[0]}")
        graphs = tuple(fleet._GRAPHS[key].graphs)
        if len(graphs) != 4 or set(graphs) != set(prog.graphs) or \
                prog.graphs != graph_names(True):
            raise AssertionError(f"{prog.name}: graphs {graphs}, registry "
                                 f"{prog.graphs}")
        matched.append(prog.name)
    if len(matched) != len(EP_METHODS) * 2:      # T = 8 and 11: b8, b16
        raise AssertionError(f"phase 4 keys at C=5: {matched}")
    key_ops = graph_audit.key_op_multiset(5, dev)
    bad = graph_audit.check_key_ops(
        key_ops, graph_audit.key_op_multiset(16, dev), "C=5 vs C=16")
    if bad:
        raise AssertionError(bad)
    print(f"graph audit live: {len(phase4_keys)} keys phase 4 captured at "
          f"C=5, each a registry entry ({', '.join(sorted(matched))}) with "
          f"its 4 graphs {graph_names(True)}; slot_camera_keys on the card: "
          f"{sum(key_ops.values())} aten ops at C=5 = at C=16 "
          f"({graph_audit.FOLDS} threefry fold-ins)")

    def gb(x) -> str:
        return f"{x / 1e9:.2f} GB"
    for arch, shape, kind, layers, why in DRYRUN_CUTS:
        res = dryrun.run_cell(arch, shape, layers)
        pub = res["published"]
        line = (f"dryrun {arch} {shape} (python -m repro_torch.launch.dryrun"
                f"): published {pub['layers']} layers: weights "
                f"{gb(pub['weights_bytes'])}, AdamW {gb(pub['adamw_bytes'])}"
                f", cache {gb(pub['cache_bytes'])}, total "
                f"{gb(pub['total_bytes'])} of {gb(H100_SXM.hbm_bytes)} "
                f"({'fits' if pub['fits'] else 'does not fit'})")
        if layers is not None:
            cut = res["cut"]
            line += (f"; at {layers} layers: weights "
                     f"{gb(cut['weights_bytes'])}, AdamW "
                     f"{gb(cut['adamw_bytes'])}, cache "
                     f"{gb(cut['cache_bytes'])}, total "
                     f"{gb(cut['total_bytes'])}")
        print(f"{line}; activations not modelled. reduced: {kind} at "
              f"{layers or pub['layers']} of {pub['layers']} layers: {why}")
        if layers is None:
            continue
        got = RECORDED["allocated"].get((arch, kind, layers))
        if got is None:
            raise AssertionError(f"no allocation recorded for {arch} "
                                 f"{kind} at {layers} layers")
        for k, v in got.items():
            if v != res["cut"][k]:
                raise AssertionError(f"{arch} at {layers} layers: {k} "
                                     f"{v} allocated vs {res['cut'][k]} in "
                                     "the dry run")
        print(f"dryrun {arch} at {layers} layers = the phase's allocation "
              "on the card: " + ", ".join(f"{k} {v}" for k, v in
                                          got.items()))

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quick = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quick)
    t0 = time.perf_counter()
    out = quick.main(["--device", dev.type])
    if any(v == 0 for v in out["launches"].values()):
        raise AssertionError(f"the quickstart's slot skipped a kernel "
                             f"{out['launches']}")
    print(f"quickstart (examples/quickstart_torch.py on the card, "
          f"{time.perf_counter() - t0:.1f} s): slot utility "
          f"{out['logs']['utility'][0]:.4f}, mean F1 "
          f"{out['logs']['mean_f1'][0]:.4f}; wrapper counts "
          + " ".join(f"{k} {v}" for k, v in out["launches"].items()))

    granite = get_config("granite-8b")
    for what, cfg, cell, mb in (
            ("train step", granite.replace(num_layers=LM_TRAIN_LAYERS),
             ShapeCell("phase 10", LM_TRAIN_SEQ, LM_TRAIN_ROWS, "train"), 2),
            ("decode", granite, ShapeCell("phase 7", FULL_SEQ, FULL_SLOTS,
                                          "decode"), 1)):
        t = analytic_terms(cfg, cell, mb, MeshDims(1, 1, 1), H100_SXM)
        ms = RECORDED["measured"][f"granite-8b {what.split()[0]}"]
        print(f"roofline granite-8b {what} ({cfg.num_layers} layers, "
              f"{cell.global_batch} x {cell.seq_len}, one card): compute "
              f"{t['a_compute_s'] * 1e3:.3f} ms, memory "
              f"{t['a_memory_s'] * 1e3:.3f} ms, collective "
              f"{t['a_collective_s'] * 1e3:.3f} ms -> {t['a_bottleneck']}, "
              f"step {t['a_step_s'] * 1e3:.3f} ms; measured {ms:.3f} ms "
              f"(the roofline step is {100 * t['a_step_s'] * 1e3 / ms:.1f}% "
              f"of it) {tag}")


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
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.data.scenarios import make_faults
    from repro_torch.data.synthetic import (DeviceScene, MultiCameraScene,
                                            SceneConfig, bandwidth_trace,
                                            segments_device)
    from repro_torch.kernels import build
    from repro_torch.kernels.cc_label import ops as cc_ops
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.knapsack_dp import ref as dp_ref
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    from repro_torch.models.detector import load_detector

    counters = {"edge_motion": em_ops, "tx_codec": tx_ops,
                "knapsack_dp": dp_ops, "flash_decode": fd_ops,
                "cc_label": cc_ops}

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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python "
          f"{sys.version.split()[0]}")
    tag = f"[{smi}]"

    t0 = time.perf_counter()
    libs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{len(libs)} sources (nvcc, sm_90a, in parallel)")
    for name in libs:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():   # written by the nvcc run of this build
            print(f"ptxas {name}: " + "; ".join(ptxas_lines(log.read_text())))

    # -- 8 (kernel times), taken first: a one-kernel window opened after
    # any other profiled work loses records (``profile_window`` raises)
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 8 (first): kernel "
          "times")
    kernel_records = kernel_time_records(torch, dev, tag)
    print_kernel_times(kernel_records, tag)

    # -- 3. kernels vs their plain versions on the card -----------------
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 3: kernels vs plain")
    bs, thr = 8, 0.35
    worst = {"edge_motion": 0.0, "tx_codec": 0.0, "knapsack_dp": 0.0}
    em_cases = {}
    # ROIDet's motion masks of the scenes' slot: what cc_label labels
    scene_masks = scene_motion_masks(torch, dev, bs, thr)
    for C in (5, 16):
        scene = DeviceScene(SceneConfig(seed=7, num_cameras=C), device=dev)
        frames = segments_device(scene.cfg, scene.params, scene.key, 3,
                                 gt_pad=scene.G)[0]
        ref_frames = segments_device(scene.cfg, scene.params, scene.key, 2,
                                     gt_pad=scene.G)[0][:, -1:]
        gen = torch.Generator(device=dev).manual_seed(C)
        noise_fr = torch.rand(frames.shape, device=dev, generator=gen)
        em_cases[f"C={C} roidet"] = frames.contiguous()
        em_cases[f"C={C} reducto"] = torch.cat([ref_frames, frames], dim=1)
        em_cases[f"C={C} uniform"] = noise_fr
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
            if not torch.equal(got, want):
                raise AssertionError("tx_codec differs from its plain "
                                     "version")
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
            if err != 0.0:
                raise AssertionError("tx_codec CRF differs from its plain "
                                     "version")

    dp_cases = []
    worst["edge_motion"] = check_edge_motion(torch, dev, em_cases, bs, thr)
    del em_cases
    for I, W, kind in ((5, 127, "uniform"), (16, 127, "uniform"),
                       (32, 200, "uniform"), (5, 127, "dead"),
                       (16, 127, "dead"), (5, 127, "ties"),
                       (16, 127, "ties"), (1, 127, "uniform"),
                       (8, 20000, "uniform")):
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
    worst["knapsack_dp"] = check_knapsack(torch, dev, dp_cases)
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
    for I, W, kind, util in dp_cases[:7]:
        for Wh in (I, 60, W):
            before = dp_ops.LAUNCHES
            got = dp_ops.solve(util, np.asarray(DP_COSTS, np.int32), Wh,
                               device=dev)
            if dp_ops.LAUNCHES != before + 1:
                raise AssertionError("the host solve is not one launch")
            want = dp_ops.solve(util, np.asarray(DP_COSTS, np.int32), Wh,
                                device="cpu")
            if not (np.array_equal(got[0], want[0]) and got[1] == want[1]):
                raise AssertionError(f"host solve ({I}, 6, {W + 1}) {kind} "
                                     f"W={Wh}: card {got} vs CPU {want}")
    print("knapsack_dp host solve on the card equals the CPU's (picks and "
          "total) for every case at W = I, 60 and the capacity, one launch "
          "each")

    worst["tx_codec"] = max(worst["tx_codec"],
                            check_tx_codec_ragged(torch, dev))
    worst["flash_decode"] = max(check_flash_decode(torch, dev).values())
    cc_parity = cc_cases(torch, dev, scene_masks)
    worst["cc_label"] = check_cc_label(torch, dev, cc_parity)
    sweep_err = check_tx_codec_sweep(torch, dev)
    worst["tx_codec"] = max(worst["tx_codec"], sweep_err)

    # -- 3b-3d. the offline profile at full width, whose artifacts every
    # later phase runs on; the control scan; Fig. 3 ----------------------
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 3b: profile")
    t_new = time.perf_counter()
    light_h, server_h = load_detector("light", "cpu"), load_detector(
        "server", "cpu")
    prof_sys, prof_launches = profile_phase(torch, dev, light_h, server_h,
                                            reset_counts, read_counts, tag)
    arts = artifacts_of(prof_sys)
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 3c: "
          "fleet_control_scan")
    control_scan_phase(torch, dev, prof_sys, reset_counts, read_counts)
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 3d: Fig. 3")
    fig3_cpu = give_artifacts(DeepStreamSystem(
        SystemConfig(eval_frames=5), light_h, server_h, device="cpu"), arts)
    fig3_cpu._key = prof_sys._key.cpu()
    fig3_phase(torch, prof_sys, fig3_cpu, reset_counts, read_counts, tag)
    print(f"phases 3b-3d (profile, control scan, Fig. 3): "
          f"{time.perf_counter() - t_new:.1f} s")

    # -- 4. the episode, graph-replayed: card vs eager, vs CPU -----------
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 4: episode")

    def make_system(C: int, device, **kw) -> DeepStreamSystem:
        """A system on scene seed 7 holding the profiled artifacts."""
        return give_artifacts(DeepStreamSystem(SystemConfig(scene=SceneConfig(
            seed=7, num_cameras=C), **kw), light_h, server_h, device=device),
            arts, C)

    def needs(method: str) -> tuple:
        """The kernels a method's main path launches."""
        deep = method.startswith("deepstream")
        return (("edge_motion",) if deep or method == "reducto" else ()) + (
            "tx_codec",) + (("knapsack_dp",) if deep or method == "jcab"
                            else ()) + (("cc_label",) if deep else ())

    def scene_of(system):
        return DeviceScene(system.cfg.scene, device=system.device)

    # on the card every solve is the fused kernel: the plain backtrack
    # must see CUDA tensors nowhere on the main path
    backtracks = []
    plain_backtrack = dp_ref.backtrack_device

    def counted_backtrack(choices, *a, **kw):
        backtracks.append(choices.device.type)
        return plain_backtrack(choices, *a, **kw)

    dp_ref.backtrack_device = counted_backtrack
    trace11 = bandwidth_trace("medium", 11, seed=3)
    trace = trace11[:T_SLOTS]
    gpu_sys, cpu_sys = make_system(5, dev), make_system(5, "cpu")
    replays = []     # (what, C, T, run, launches each kernel must make)
    episode_logs = {}
    n_graphs = fleet_mod.episode_graph_count()
    keys_before = set(fleet_mod._GRAPHS)
    for C in (5, 16):
        g_sys = gpu_sys if C == 5 else make_system(C, dev)
        e_sys = make_system(C, dev, episode_pipelined=False)
        c_sys = cpu_sys if C == 5 else make_system(C, "cpu")
        tr11 = trace11 * C / 5
        for method in EP_METHODS:
            # the CPU's 11 slots; their first 8 are the 8-slot run's
            cpu_logs = c_sys.run_episode(scene_of(c_sys), tr11, method)
            for T in (8, 11):
                tr = tr11[:T]
                what = f"episode {method} C={C} T={T}"
                # the first run builds the graphs from the kernels' wrappers
                # (eager warm-up, then capture)
                reset_counts()
                first = g_sys.run_episode(scene_of(g_sys), tr, method)
                n_capture = read_counts()
                if any(n_capture[k] == 0 for k in needs(method)):
                    raise AssertionError(f"{what}: the capture went through "
                                         f"no wrapper of {needs(method)}: "
                                         f"{n_capture}")
                captured = fleet_mod.episode_graph_count()
                scene = scene_of(g_sys)
                reset_counts()
                # the timed region: nothing may wait on the card, and the
                # replays call no kernel wrapper (no eager slot step)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = g_sys._episode_dispatch(scene, tr, method)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                n_replay = read_counts()
                logs = g_sys._episode_logs(out, tr)
                if fleet_mod.episode_graph_count() != captured:
                    raise AssertionError(f"{what}: a second run captured a "
                                         "graph")
                if any(n_replay.values()):
                    raise AssertionError(f"{what}: the replayed run called "
                                         f"kernel wrappers {n_replay}")
                same_logs(first, logs, f"{what} second run")
                check_logs(logs, f"episode {method}")
                # the kernels a replayed run launched, as the card records
                # them (once per slot for each kernel of the method's
                # path), are counted in phase 9
                replays.append((what, C, T, lambda g=g_sys, tr=tr, m=method:
                                g.run_episode(scene_of(g), tr, m),
                                {k: T if k in needs(method) else 0
                                 for k in counters}))
                eager = e_sys._episode_logs(e_sys._episode_dispatch(
                    scene_of(e_sys), tr, method, _eager=True), tr)
                same_logs(eager, logs, f"episode {method} C={C} T={T} graph "
                          "vs the eager reference body")
                diffs = max_log_diff({k: v[:T] for k, v in cpu_logs.items()},
                                     logs, LOG_KEYS, 1e-5)
                print(f"{what} (bucket {fleet_mod.bucket_len(T)}): wrapper "
                      "calls at capture "
                      + " ".join(f"{k} {v}" for k, v in n_capture.items())
                      + ", at replay 0"
                      + "; no host sync under set_sync_debug_mode('error'); "
                      "second run 0 captures; graph = eager reference body "
                      f"bitwise; mean F1 {float(np.mean(logs['mean_f1'])):.4f}"
                      "; card vs CPU max diff "
                      + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))
                if C == 5 and T == T_SLOTS:
                    episode_logs[method] = logs
    print(f"episode graphs captured: "
          f"{fleet_mod.episode_graph_count() - n_graphs} (4 per method, C "
          "and bucket: two halves of the pipelined step and two drains)")
    # the C=5 graph keys phase 12 holds against the audit's registry
    phase4_keys = [k for k in fleet_mod._GRAPHS
                   if k not in keys_before and k[0].num_cams == 5]

    # a fault family, then a chain of two windows through the carry
    T = T_SLOTS
    faults = make_faults("camera_churn", T, 5, seed=4)
    e_sys = make_system(5, dev, episode_pipelined=False)
    for method in EP_METHODS:
        before = fleet_mod.episode_graph_count()
        logs = gpu_sys.run_episode(scene_of(gpu_sys), trace, method,
                                   faults=faults)
        if fleet_mod.episode_graph_count() != before:
            raise AssertionError("a fault mask captured a graph")
        eager = e_sys._episode_logs(e_sys._episode_dispatch(
            scene_of(e_sys), trace, method, faults=faults, _eager=True),
            trace)
        same_logs(eager, logs, f"churn {method} graph vs eager reference")
        cpu_logs = cpu_sys.run_episode(scene_of(cpu_sys), trace, method,
                                       faults=faults)
        diffs = max_log_diff(cpu_logs, logs, LOG_KEYS, 1e-5)
        print(f"episode {method} C=5 T={T} camera_churn ({int(faults.sum())}"
              f" of {faults.size} camera-slots live): graph = eager "
              "reference body bitwise, no capture; card vs CPU max diff "
              + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))
    faults11 = make_faults("camera_churn", 11, 5, seed=6)
    for method in ("deepstream", "reducto", "deepstream_no_elastic"):
        whole = gpu_sys.run_episode(scene_of(gpu_sys), trace11, method,
                                    faults=faults11)
        scene = scene_of(gpu_sys)
        w1 = gpu_sys.run_episode(scene, trace11[:4], method,
                                 faults=faults11[:4])
        w2 = gpu_sys.run_episode(scene, trace11[4:], method,
                                 faults=faults11[4:],
                                 carry=gpu_sys.last_carry)
        chain = {k: np.concatenate([w1[k], w2[k]]) for k in w1}
        diffs = max_log_diff(whole, chain, LOG_KEYS, 1e-5,
                             "carried windows vs one run")
        print(f"episode {method} C=5: windows of 4 and 7 slots through the "
              "carry vs one 11-slot run (camera_churn), max diff "
              + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))

    # -- 5. run(), pipelined, four methods -------------------------------
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 5: run()")
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
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 6: host control "
          "and the sequential runner")
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
    dp_ref.backtrack_device = plain_backtrack
    print(f"backtrack_device calls during the card's runs: "
          f"{backtracks.count('cuda')} on CUDA tensors, "
          f"{backtracks.count('cpu')} on CPU tensors")
    if "cuda" in backtracks:
        raise AssertionError("a device solve on the card took the plain "
                             "backtrack")
    if launches_run["edge_motion"] != 2 * T_SLOTS:
        raise AssertionError(f"run(): edge_motion launched "
                             f"{launches_run['edge_motion']} times, not "
                             f"{2 * T_SLOTS} (ROIDet and reducto per slot)")

    # -- 6b. crash-safe fleet serving --------------------------------------
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 6b: the fleet "
          "stream")
    t_new = time.perf_counter()
    stream_runners, stream_worst = stream_phase(
        torch, dev, light_h, server_h, arts, reset_counts, read_counts, needs,
        tag)
    for k, e in stream_worst.items():
        worst[k] = max(worst[k], e)
    print(f"phase 6b (the fleet stream): {time.perf_counter() - t_new:.1f} s")

    # -- 7. the LM serving tier: small width card vs CPU, then full width
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 7: LM serving")
    lm_card_vs_cpu(torch, dev)
    lm_launches = lm_full_width(torch, dev, tag, reset_counts, read_counts)

    # -- 8. times --------------------------------------------------------
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 8: times")
    # ms/slot of the graph-replayed episode (the pipelined body and the
    # reference body), the eager episode and run(): CUDA events around each
    # whole run (harvest included), the four in turns, one warm-up round
    # (which captures the graphs) and TIMED_ROUNDS timed ones
    for C in (5, 16):
        s = gpu_sys if C == 5 else make_system(C, dev)
        s_ref = make_system(C, dev, episode_pipelined=False)
        tr = trace * C / 5
        for method in METHODS:
            runners = {
                "episode graph": lambda sc, m=method: s.run_episode(
                    sc, tr, m),
                "episode graph reference body": (
                    lambda sc, m=method: s_ref.run_episode(sc, tr, m)),
                "episode eager": lambda sc, m=method: s._episode_logs(
                    s._episode_dispatch(sc, tr, m, _eager=True), tr),
                "run": lambda sc, m=method: s.run(sc, tr, m)}
            names = list(runners)
            ms = {r: [] for r in runners}
            for rnd in range(TIMED_ROUNDS + 1):
                for r in (names if rnd % 2 == 0 else names[::-1]):
                    scene = scene_of(s)
                    t_ms = event_ms(torch, lambda: runners[r](scene))
                    t_ms /= T_SLOTS
                    if rnd > 0:
                        ms[r].append(t_ms)
            for r in names:
                print(f"ms/slot {r} {method} C={C} T={T_SLOTS}: median "
                      f"{statistics.median(ms[r]):.3f} (min {min(ms[r]):.3f}"
                      f", max {max(ms[r]):.3f}, {TIMED_ROUNDS} runs) {tag}")
            med = {r: statistics.median(v) for r, v in ms.items()}
            ref_pipe = (med["episode graph reference body"]
                        / med["episode graph"])
            print(f"ms/slot {method} C={C}: eager / graph = "
                  f"{med['episode eager'] / med['episode graph']:.2f}, "
                  "graph reference body / graph pipelined = "
                  f"{ref_pipe:.3f}")
    # run() on a host scene (segments rendered by numpy, frames and GT
    # uploaded per slot) beside the same run on a DeviceScene, in turns
    scene_kinds = {"host scene": lambda: MultiCameraScene(gpu_sys.cfg.scene),
                   "DeviceScene": lambda: scene_of(gpu_sys)}
    ms = {k: [] for k in scene_kinds}
    for rnd in range(TIMED_ROUNDS + 1):
        for k in (list(scene_kinds) if rnd % 2 == 0
                  else list(scene_kinds)[::-1]):
            scene = scene_kinds[k]()
            t_ms = event_ms(torch, lambda: gpu_sys.run(
                scene, trace, "deepstream")) / T_SLOTS
            if rnd > 0:
                ms[k].append(t_ms)
    for k, v in ms.items():
        print(f"ms/slot run deepstream C=5 T={T_SLOTS} {k}: median "
              f"{statistics.median(v):.3f} (min {min(v):.3f}, max "
              f"{max(v):.3f}, {TIMED_ROUNDS} runs) {tag}")

    # each kernel's times (taken first, in the child processes); the
    # launch counts and the parity errors come from the phases above
    records = kernel_records
    for rec, launches in zip(records, (
            launches_run["edge_motion"], launches_run["tx_codec"],
            launches_run["knapsack_dp"], lm_launches,
            launches_run["cc_label"])):
        rec.update(launches=launches, max_abs_err=worst[rec["name"]])
        if rec["name"] != "flash_decode":
            rec["launches_episode"] = None      # counted in phase 9
    for at in records[1]["at_shape"].values():
        at["launches_profile"] = prof_launches["tx_codec"]
    print(f"kernel tx_codec sweep: {prof_launches['tx_codec']} launches in "
          f"the {PROFILE_SLOTS}-slot profile")

    # -- 9. the replayed episodes' launches as the card recorded them ----
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 9: episode launches "
          "(CUPTI)")
    launches_episode = dict.fromkeys(counters, 0)
    for what, C, T, run, want in replays:
        reset_counts()
        n = recorded_launches(torch, run, want, what)
        if any(read_counts().values()):
            raise AssertionError(f"{what}: the replayed run called kernel "
                                 f"wrappers {read_counts()}")
        print(f"{what}: kernels the card ran (CUPTI records) "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + ", wrapper calls 0")
        if C == 5 and T == T_SLOTS:
            for k in counters:
                launches_episode[k] += n[k]
    # one window of the stream per method (C=5, 8 slots), replayed
    launches_stream = dict.fromkeys(counters, 0)
    for method, (r, tr, lv) in stream_runners.items():
        want = {k: STREAM_WINDOW if k in needs(method) else 0
                for k in counters}
        reset_counts()
        n = recorded_launches(torch, lambda r=r, tr=tr, lv=lv: stream_window(
            r, tr, lv), want, f"stream {method} window")
        if any(read_counts().values()):
            raise AssertionError(f"stream {method}: a replayed window called "
                                 f"kernel wrappers {read_counts()}")
        print(f"stream {method} C=5: one window of {STREAM_WINDOW} slots, "
              "kernels the card ran (CUPTI records) "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + ", wrapper calls 0")
        for k in counters:
            launches_stream[k] += n[k]
    # -- 10. training: the detectors' trainer, granite-8b, the launcher
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 10: training")
    t_new = time.perf_counter()
    train_launches = train_phase(
        torch, dev, tag, reset_counts, read_counts,
        lambda server: give_artifacts(DeepStreamSystem(SystemConfig(
            scene=SceneConfig(seed=7, num_cameras=5)), light_h, server,
            device=dev), arts, 5),
        scene_of, trace, episode_logs["deepstream"],
        {k: T_SLOTS if k in needs("deepstream") else 0 for k in counters})
    print(f"phase 10 (training): {time.perf_counter() - t_new:.1f} s")
    # -- 11. the other LM families and the int8 cache, serving and
    # training
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 11: LM families")
    t_new = time.perf_counter()
    fam_launches = families_phase(torch, dev, tag, reset_counts, read_counts)
    print(f"phase 11 (LM families): {time.perf_counter() - t_new:.1f} s")
    # -- 12. the static audit, the dry run, the quickstart, the roofline
    print(f"[{time.perf_counter() - t_begin:.1f} s] phase 12: audit, "
          "roofline, dry run, examples")
    t_new = time.perf_counter()
    audit_phase(torch, dev, tag, gpu_sys, trace11, phase4_keys)
    print(f"phase 12 (audit, roofline, dry run, examples): "
          f"{time.perf_counter() - t_new:.1f} s")
    for rec in records:
        if "launches_episode" in rec:
            rec["launches_episode"] = launches_episode[rec["name"]]
        rec["launches_profile"] = prof_launches[rec["name"]]
        rec["launches_stream"] = launches_stream[rec["name"]]
        rec["launches_train"] = train_launches["train"]
        rec["launches_train_episode"] = train_launches["train_episode"][
            rec["name"]]
        rec["launches_families"] = (fam_launches
                                    if rec["name"] == "flash_decode" else 0)

    if args.profile:
        from torch.autograd import DeviceType
        for C, label, run in (
                (5, "graph", lambda sc: gpu_sys.run_episode(
                    sc, trace, "deepstream")),
                (5, "eager", lambda sc: gpu_sys._episode_logs(
                    gpu_sys._episode_dispatch(sc, trace, "deepstream",
                                              _eager=True), trace))):
            scene = scene_of(gpu_sys)
            torch.cuda.synchronize()
            with profiler(torch, "--profile's episodes") as prof:
                t0 = time.perf_counter()
                run(scene)
                wall = time.perf_counter() - t0
                time.sleep(0.05)   # the card's activity records arrive late
            dev_us = device_us(prof)
            n_kernels = sum(e.count for e in prof.key_averages()
                            if e.device_type == DeviceType.CUDA
                            and not e.is_user_annotation)
            dev_ms = dev_us / 1e3
            print(f"profile episode {label} deepstream C={C} T={T_SLOTS}: "
                  f"wall {wall * 1e3:.1f} ms, {n_kernels} kernels on the card "
                  f"({n_kernels / T_SLOTS:.0f} per slot) taking "
                  f"{dev_ms:.1f} ms ({dev_ms / T_SLOTS:.2f} ms per slot, "
                  f"{100 * dev_ms / (wall * 1e3):.1f}% busy) {tag}")
            print(prof.key_averages().table(sort_by="self_device_time_total",
                                            row_limit=12))
        # where each runner still waits on the card (host syncs per site):
        # the episode's dispatch and its harvest apart
        import collections
        import warnings

        def flagged(fn) -> collections.Counter:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            return collections.Counter(
                f"{Path(w.filename).name}:{w.lineno}" for w in caught)

        for method in METHODS:
            scene = scene_of(gpu_sys)
            box = {}
            in_dispatch = flagged(lambda: box.update(out=(
                gpu_sys._episode_dispatch(scene, trace, method))))
            at_harvest = flagged(lambda: gpu_sys._episode_logs(box["out"],
                                                               trace))
            print(f"host syncs run_episode {method} C=5 T={T_SLOTS}: "
                  f"{sum(in_dispatch.values())} before the harvest "
                  f"{dict(in_dispatch)}, {sum(at_harvest.values())} at the "
                  f"harvest {dict(at_harvest)}")
            if in_dispatch:
                raise AssertionError("run_episode waits on the card before "
                                     "its harvest")
            scene = scene_of(gpu_sys)
            sites = flagged(lambda: gpu_sys.run(scene, trace, method))
            print(f"host syncs run {method} C=5 T={T_SLOTS}: "
                  f"{sum(sites.values())} {dict(sites.most_common())}")

    print(f"chip_smoke wall time: {time.perf_counter() - t_begin:.1f} s "
          f"{tag}")
    print(json.dumps({"kernels": records}, allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
