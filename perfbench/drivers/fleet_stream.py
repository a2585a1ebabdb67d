"""Driver of the fleet stream cells: the crash-safe windowed serving of
``repro_torch.serve.stream`` as ``repro_torch.launch.serve --fleet-stream``
runs it.

Set-up builds the configuration's system (the committed light detector,
the server detector from the builder that the configuration's
``detectors.server_program`` names, the utility MLP from ``PRNGKey(0)``,
thresholds, the linspace jcab table) and its ``StreamingFleetRunner`` with
checkpoints at every window into a fresh directory under the run's
temporary directory, then serves the warm-up windows, which capture the
episode's CUDA graphs.  The measured window is
a closed loop of one producer: offer ``window_slots`` slots of the traffic
stream, ``serve()``, repeat, until ``--seconds`` have passed.  A traced
run then serves ``span_windows`` more windows with the program's span
recorder on and no profiler, whose host spans are the untraced program's,
and ``trace_windows`` more under the profiler, whose device trace and
stage marks the per-layer readers take (``perfbench/core/spans.py``).

After the window the program's state is freed, and the served logs of a
sample of windows drawn from the seed are held to
``perfbench/reference/fleet.py`` (see ``check``).
"""
from __future__ import annotations

import gc
import importlib
import math
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench.core import devtrace
from perfbench.core.bench import ROOT, Cell, Check, Outcome, Readings
from perfbench.core.spans import HOST, PROFILED, Recorded
from perfbench.core.traffic import make_stream
from perfbench.reference import fleet as ref_fleet

LOG_KEYS = ref_fleet.LOG_KEYS


def stream_seed(seed: int) -> int:
    """The run's seed as the scene's and the stream's seed: a uint32."""
    return int(seed) % (2 ** 32)


def server_detector(config: Dict, device):
    """The program's server detector: the builder that
    ``detectors.server_program`` names (``"module:function"``), called
    with ``device=`` and ``detectors.server_program_args`` as keywords."""
    det = config["detectors"]
    module, _, fn = det["server_program"].partition(":")
    builder = getattr(importlib.import_module(module), fn)
    return builder(device=device, **det.get("server_program_args", {}))


def build(cell: Cell, seed: int, device):
    """The program as the launcher builds it: (system, runner, scene
    config, checkpoint directory)."""
    import torch
    from repro_torch.common import prng
    from repro_torch.core import utility as util_mod
    from repro_torch.core.codec import CodecConfig
    from repro_torch.core.elastic import ElasticConfig
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.data.synthetic import DeviceScene, SceneConfig
    from repro_torch.ft.watchdog import WatchdogConfig
    from repro_torch.models.detector import load_detector
    from repro_torch.serve.stream import StreamConfig, StreamingFleetRunner

    cfg = cell.config
    dev = torch.device(device)
    sc = dict(cfg["scene"])
    sc["seed"] = stream_seed(seed)
    sc["obj_size_range"] = tuple(sc["obj_size_range"])
    scene_cfg = SceneConfig(**sc)
    sy = cfg["system"]
    sys_cfg = SystemConfig(
        scene=scene_cfg,
        codec=CodecConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg["codec"].items()}),
        elastic=ElasticConfig(**cfg["elastic"]),
        block_size=sy["block_size"], eval_frames=sy["eval_frames"],
        batched=sy["batched"], shard=sy["shard"], pipeline=sy["pipeline"],
        alloc=sy["alloc"], episode=sy["episode"],
        episode_pipelined=sy["episode_pipelined"],
        episode_buckets=tuple(sy["episode_buckets"]),
        w_cap_kbps=float(sy["w_cap_kbps"]), checked=sy["checked"])
    system = DeepStreamSystem(sys_cfg, load_detector("light", dev),
                              server_detector(cfg, dev), device=dev)
    ctl = cfg["control"]
    system.mlp = util_mod.init_utility_mlp(
        prng.PRNGKey(int(ctl["utility_mlp_seed"]), device=dev))
    system.tau_wl = float(ctl["tau_wl_kbps"])
    system.tau_wh = float(ctl["tau_wh_kbps"])
    system.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(
        np.float32)
    st = cfg["stream"]
    ckpt_dir = Path(tempfile.mkdtemp(prefix="perfbench_ckpt_"))
    runner = StreamingFleetRunner(
        system, DeviceScene(scene_cfg, device=dev, mesh=system.mesh),
        method=cfg["method"],
        cfg=StreamConfig(window_slots=st["window_slots"],
                         queue_slots=st["queue_slots"],
                         ckpt_dir=str(ckpt_dir), ckpt_every=st["ckpt_every"],
                         ckpt_keep=st["ckpt_keep"], degrade=st["degrade"],
                         recover_after=st["recover_after"],
                         install_signal=st["install_signal"],
                         watchdog=WatchdogConfig(**st["watchdog"])))
    return system, runner, ckpt_dir


class Stream:
    """The traffic stream, one day of ``day_slots`` slots repeated: slot t
    is day slot t mod ``day_slots``."""

    def __init__(self, traffic: Dict, num_cams: int, seed: int):
        self.trace, self.live = make_stream(traffic, num_cams,
                                            stream_seed(seed))
        self.L = len(self.trace)

    def slots(self, t: int, n: int):
        idx = np.arange(t, t + n) % self.L
        return self.trace[idx], self.live[idx]


def serve_window(runner, stream: Stream, t: int, n: int) -> int:
    """Offer slots [t, t + n) and serve: the producer's one step.  Returns
    the slots accepted."""
    W, live = stream.slots(t, n)
    took = runner.offer(W, faults=live)
    runner.serve()
    return took


def sample_windows(n_windows: int, first: int, count: int, seed: int
                   ) -> List[int]:
    """The windows the check recomputes: the first ``first`` (the stream's
    start, computed from the reference's own state alone), the last, and
    windows drawn from the seed up to ``count`` in all."""
    pick = set(range(min(first, n_windows)))
    pick.add(n_windows - 1)
    rest = sorted(set(range(n_windows)) - pick)
    rng = np.random.default_rng((stream_seed(seed), 0xC4EC))
    extra = max(0, min(count - len(pick), len(rest)))
    pick.update(int(w) for w in rng.choice(rest, size=extra, replace=False))
    return sorted(pick)


def reference_logs(cell: Cell, seed: int, device, stream: Stream,
                   windows: List[int], window_slots: int,
                   prog_area: np.ndarray,
                   detector_dtype=None) -> Dict[str, np.ndarray]:
    """The reference's logs of ``windows``, slot by slot from the stream's
    start.  Slots outside them advance only the elastic state, from the
    program's logged ROI area (the one piece of the program's output the
    reference follows; every slot of a compared window computes its own
    area)."""
    import torch
    dtype = torch.float32 if detector_dtype is None else detector_dtype
    ref = ref_fleet.FleetReference(
        cell.config, stream_seed(seed), device, ROOT / "artifacts", dtype,
        detectors_dir=cell.bench_dir / "reference" / "detectors")
    C = ref.spec.num_cameras
    dev = ref.device
    est = ref_fleet.elastic_init(dev)
    out: Dict[str, List[float]] = {k: [] for k in LOG_KEYS}
    want = set(windows)
    last = (max(windows) + 1) * window_slots
    W_all, live_all = stream.slots(0, last)
    live_prev = np.ones(C, bool)
    for w in range(max(windows) + 1):
        t0 = w * window_slots
        if w in want:
            packs, cpacks = [], []
            for t in range(t0, t0 + window_slots):
                pack, cpack, est = ref.slot(t, float(W_all[t]), live_all[t],
                                            est, live_prev)
                packs.append(pack)
                cpacks.append(cpack)
                live_prev = live_all[t]
            logs = ref.window_logs(W_all[t0:t0 + window_slots], packs,
                                   cpacks)
            for k in LOG_KEYS:
                out[k].extend(float(v) for v in logs[k])
            continue
        for t in range(t0, t0 + window_slots):
            live = torch.as_tensor(live_all[t], device=dev)
            prev = torch.as_tensor(live_prev, device=dev)
            area = torch.as_tensor(np.float32(prog_area[t]), device=dev)
            W_t = torch.as_tensor(np.float32(W_all[t]), device=dev)
            est, _ = ref.control(est, area, W_t, live,
                                 (live & ~prev).any())
            live_prev = live_all[t]
    return {k: np.asarray(v) for k, v in out.items()}


def program_logs(logs: Dict[str, List[float]], windows: List[int],
                 window_slots: int) -> Dict[str, np.ndarray]:
    idx = np.concatenate([np.arange(w * window_slots, (w + 1) * window_slots)
                          for w in windows])
    out = {}
    for k in LOG_KEYS:
        v = np.asarray(logs[k], np.float64)
        out[k] = v[idx] if idx.max() < len(v) else np.full(len(idx), np.nan)
    return out


def program_area(rd: Readings) -> np.ndarray:
    """The ROI area the program logged for every slot it served."""
    return np.asarray(rd.counters["program_area"], np.float64)


def log_gap(gaps: Dict[str, float]) -> float:
    g = max(gaps.values())
    return g if math.isfinite(g) else 1e300


CONV_FRAGMENTS = ("conv", "fprop", "xmma", "cudnn", "implicit", "gemm",
                  "winograd", "fft")


def conv_note(dt) -> str:
    """The detectors' convolution kernels the card ran in the traced span
    (names as recorded, seconds), which say the precision they ran in."""
    seen: Dict[str, List[float]] = {}
    for name, s in dt.kernels:
        if any(f in name.lower() for f in CONV_FRAGMENTS):
            e = seen.setdefault(name, [0, 0.0])
            e[0] += 1
            e[1] += s
    return "conv kernels: " + ("; ".join(
        f"{name[:160]} x{c} {t:.6f} s" for name, (c, t) in
        sorted(seen.items(), key=lambda kv: -kv[1][1])) or "none found")


def window_note(walls, dispatch, writes, gcs) -> str:
    """Where a window's time went, from outside the program: the runner's
    own turnaround (dispatch to harvest), the rest of each window (offer,
    supervision, the checkpoint's snapshot and its wait for the previous
    write), the writer thread's seconds per save, and the garbage
    collections in the window."""
    q = lambda xs, p: (1e3 * float(np.percentile(xs, p)) if len(xs)
                       else float("nan"))
    rest = [w - d for w, d in zip(walls, dispatch)]
    k = max(1, len(walls) // 4)
    return (f"windows {len(walls)}; mean ms of the first and last quarter "
            f"{1e3 * np.mean(walls[:k]):.3f} / {1e3 * np.mean(walls[-k:]):.3f}"
            f"; window parts ms p50/p95/max: runner turnaround "
            f"{q(dispatch, 50):.3f}/{q(dispatch, 95):.3f}/{q(dispatch, 100):.3f}"
            f"; rest {q(rest, 50):.3f}/{q(rest, 95):.3f}/{q(rest, 100):.3f}"
            f"; writer per save {q(writes, 50):.3f}/{q(writes, 95):.3f}/"
            f"{q(writes, 100):.3f}; gc collections {gcs}")


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_origin: float, max_windows: Optional[int] = None) -> Outcome:
    """One run of a fleet stream cell (``max_windows`` caps the measured
    window's length, for tests on the CPU)."""
    import torch
    from repro_torch.common import trace as recorder
    from repro_torch.core import fleet as fleet_mod

    tr = cell.traffic
    cfg = cell.config
    rd = Readings(cell)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    C = int(cfg["scene"]["num_cameras"])
    n = int(cfg["stream"]["window_slots"])
    stream = Stream(tr, C, seed)
    b0 = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.zeros((), device=dev)
    b1 = time.perf_counter()
    rd.span("cuda_context", b0, b1)
    system, runner, ckpt_dir = build(cell, seed, dev)
    rd.span("build", b1, time.perf_counter())
    rd.counters["cameras"] = C
    rd.counters["cudnn_allow_tf32"] = bool(torch.backends.cudnn.allow_tf32)
    rd.counters["matmul_allow_tf32"] = bool(
        torch.backends.cuda.matmul.allow_tf32)
    H, W = cfg["scene"]["height"], cfg["scene"]["width"]
    N = int(cfg["scene"]["fps"] * cfg["scene"]["seg_seconds"])
    bs = int(cfg["system"]["block_size"])
    rd.counters["kernel_shapes"] = {
        "edge_motion": (C, N, H, W, bs), "tx_codec": (C, N, H, W),
        "knapsack_dp": (C, len(cfg["codec"]["bitrates_kbps"]),
                        ref_fleet.dp_capacity(ref_fleet.FleetSpec.of(cfg))
                        + 1),
        "cc_label": (C, H // bs, W // bs),
        # synthesis's and encode's draws: a key a camera, (N, H, W) each
        "threefry_normal": (C, N * H * W)}
    pos = {"t": 0, "windows": 0, "attempted": 0, "failed": 0}

    def step() -> int:
        """One window of the producer: offer n slots, serve them."""
        took = serve_window(runner, stream, pos["t"], n)
        pos["t"] += took
        pos["windows"] += 1
        return took

    try:
        runner.restore()       # a fresh directory: nothing to restore
        sync()
        c0 = time.perf_counter()
        for _ in range(int(tr["warmup_windows"])):
            step()
        sync()
        rd.span("capture", c0, time.perf_counter())
        graphs0 = fleet_mod.episode_graph_count()
        snaps0 = len(runner.saver.snapshot_s)
        walls0 = len(runner.window_walls)
        writes0 = len(runner.saver.write_s)
        gc_before = sum(g["collections"] for g in gc.get_stats())
        # the measured window: a closed loop of one producer
        w_start = time.perf_counter()
        rd.span("setup", t_origin, w_start)
        rd.notes.append("setup parts s: " + ", ".join(
            f"{k} {rd.total(k):.3f}" for k in ("cuda_context", "build",
                                                "capture")))
        degraded = served = 0
        while True:
            rung = runner.rung
            a = time.perf_counter()
            took = step()
            b = time.perf_counter()
            rd.span("serve_window", a, b)
            served += took
            degraded += rung > 0
            pos["attempted"] += 1
            pos["failed"] += took < n
            if b - w_start >= seconds or (max_windows is not None
                                          and pos["attempted"] >= max_windows):
                break
        rd.span("window", w_start, b)
        rd.counters["slots"] = served
        rd.counters["camera_slots"] = served * C
        rd.counters["degraded_windows"] = degraded
        rd.counters["graph_captures_in_window"] = (
            fleet_mod.episode_graph_count() - graphs0)
        rd.counters["ckpt_snapshot_s"] = list(
            runner.saver.snapshot_s[snaps0:])
        rd.notes.append(window_note(
            rd.durations("serve_window"), runner.window_walls[walls0:],
            runner.saver.write_s[writes0:],
            sum(g["collections"] for g in gc.get_stats()) - gc_before))
        if trace:
            # the recorder holds this run's parts alone; each part's window
            # ids tell the readers which spans are whose
            parts = {HOST: [], PROFILED: []}
            rd.counters["span_windows"] = parts
            recorder_was_on = recorder.active()
            recorder.clear()
            recorder.enable()
            try:
                served_in = []
                for _ in range(int(tr.get("span_windows", 0))):
                    served_in.append(step())
                    parts[HOST].append(runner.window)
                traced = []

                def span():
                    for _ in range(int(tr["trace_windows"])):
                        with torch.profiler.record_function(
                                "perfbench.offer+serve"):
                            traced.append(step())
                        parts[PROFILED].append(runner.window)

                if on_card:
                    rd.device = devtrace.profiled(torch, span)
                    rd.notes.append(conv_note(rd.device))
                else:
                    span()
            finally:
                recorder.enable(recorder_was_on)
            rd.counters["trace_slots"] = sum(traced)
            pos["attempted"] += len(served_in) + len(traced)
            pos["failed"] += sum(x < n for x in served_in + traced)
        peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    finally:
        runner.close()      # waits for the last checkpoint write
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if trace:
        rd.counters["span_recorder"] = Recorded(recorder.spans())
    logs = {k: list(v) for k, v in runner.logs.items()}
    rd.counters["program_area"] = logs["area"]
    # free the program's state before the reference runs
    del runner, system
    fleet_mod._GRAPHS.clear()
    if on_card:
        sync()
        torch.cuda.empty_cache()
    checks = check(cell, seed, dev, stream, logs, pos["windows"], n, rd)
    return Outcome(readings=rd, checks=checks, attempted=pos["attempted"],
                   failed=pos["failed"], memory_peak_bytes=peak,
                   device_kind=(torch.cuda.get_device_name(dev) if on_card
                                else "cpu"),
                   device_count=cell.chips)


def check(cell: Cell, seed: int, dev, stream: Stream,
          logs: Dict[str, List[float]], n_windows: int, n: int,
          rd: Readings, detector_dtype=None) -> List[Check]:
    """Hold a sample of the served windows to the reference: the widest
    relative gap of any log key (``log_gap``), the slots compared, and
    whether the run kept the precision the configuration states."""
    ck = cell.config["check"]
    windows = sample_windows(n_windows, int(ck["first_windows"]),
                             int(ck["windows"]), seed)
    prog = program_logs(logs, windows, n)
    ref = reference_logs(cell, seed, dev, stream, windows, n,
                         np.asarray(logs["area"], np.float64),
                         detector_dtype)
    gaps = ref_fleet.compare(prog, ref)
    rd.counters["log_gaps"] = gaps
    rd.notes.append("log gaps: " + ", ".join(f"{k} {v!r}"
                                             for k, v in sorted(gaps.items())))
    rd.counters["checked_windows"] = windows
    rd.reference = ref
    prec = cell.config["precision"]
    as_stated = (rd.counters["cudnn_allow_tf32"] == prec["cudnn_allow_tf32"]
                 and rd.counters["matmul_allow_tf32"]
                 == prec["matmul_allow_tf32"])
    want_slots = min(int(ck["windows"]), n_windows) * n
    return [Check("log_gap", log_gap(gaps), ck["log_gap_limit"]),
            Check("slots_compared", float(len(prog["W"])), float(want_slots),
                  at_most=False),
            Check("precision_as_stated", float(as_stated), 1.0,
                  at_most=False)]
