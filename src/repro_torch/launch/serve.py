"""Serving launcher: the LM engine, or the crash-safe fleet stream.

LM engine (continuous-batched decode over any config of
``repro_torch.configs`` but the audio family, which the engine refuses)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        [--smoke] [--device cpu] --requests 6 --slots 4 --prompt-len 24 \
        --max-new 8

Weights are a random initialisation from seed 0, made on the device;
prompts are random tokens from seed 0; a vlm request sees zero image
embeddings.

Fleet stream (``serve.stream``: windowed serving over the episode's CUDA
graphs, the carry checkpointed at every window boundary; run the same
command again after a kill and it restores from the newest valid
checkpoint and goes on)::

    PYTHONPATH=src python -m repro_torch.launch.serve --fleet-stream \
        [--device cpu] --stream-slots 64 --window-slots 8 \
        --method deepstream --ckpt-dir artifacts/serve_ckpt --ckpt-keep 8

The fleet is the JAX launcher's: ``SceneConfig(seed=33)`` (5 cameras,
96 x 160, 10 frames a segment), ``eval_frames=3``, the capacity pinned at
8000 Kbps (scaled by C / 5 above 5 cameras, as the soak stream is), the
committed detectors (``artifacts/detector_{light, server}``; with
``--server-detector yolov8s`` the server detector is Ultralytics YOLOv8s
at 384 x 640 with seeded weights, ``models/yolov8.py``), the
utility MLP of ``init_utility_mlp(PRNGKey(0))``, thresholds 10 / 50 Kbps
and the linspace jcab table; the stream is
``make_soak_stream(--stream-slots)``.  ``--trace`` records the program's
spans (``common.trace``) and prints each span's count, p50 and p95 in ms
and each counter after the serving stats.  ``--source file:PATH`` tails a
line-protocol file and ``--source HOST:PORT`` reads the protocol over TCP
(``serve.ingest``: quarantine, slot sequencing, read backoff), one
``"<t> <kbps> <live-bits>"`` record per slot.  Without ``--device`` both
modes run on the card and raise if there is none.

The fleet stream over several cards, one process per card, each serving
its block of the camera mesh (``sharding.rules``; rank 0 alone prints
and writes the checkpoints, which restore at any world size)::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --fleet-stream --stream-slots 64 \
        --ckpt-dir artifacts/serve_ckpt

Under ``torchrun`` the mesh spans every rank, one rank included (a
one-card mesh exercises the collectives); ``--num-cameras`` sets the
fleet (5 by default).

The LM engine under ``torchrun`` serves on the LM mesh (a one-rank world
on ``make_host_mesh()``, a larger one on ``make_production_mesh()``:
"model" over ``--model`` ranks, default the ranks of one node): every
rank drives the same requests over its pieces of the weights and cache,
and rank 0 prints::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch granite-8b --model 4
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch.common import trace
from repro_torch.common.device import resolve_device

# the launcher's pinned DP capacity at 5 cameras (the JAX launcher's)
W_CAP_KBPS = 8000.0


def span_summary() -> Dict[str, Dict[str, float]]:
    """Per span name of the recorder: count, p50 and p95 in ms."""
    by: Dict[str, List[float]] = {}
    for sp in trace.spans():
        by.setdefault(sp.name, []).append(sp.seconds)
    return {name: {"n": len(v),
                   "p50_ms": round(1e3 * float(np.percentile(v, 50)), 4),
                   "p95_ms": round(1e3 * float(np.percentile(v, 95)), 4)}
            for name, v in sorted(by.items())}


def fleet_system_config(num_cameras: int, launched: bool = False):
    """The launcher's episode-mode ``SystemConfig`` at ``num_cameras``:
    scene seed 33, ``eval_frames=3`` and the DP capacity pinned at
    ``W_CAP_KBPS`` x max(1, C / 5).  ``make_soak_stream`` scales its
    bandwidth by C / 5, so at 16 cameras its diurnal peak plus the
    elastic borrow passes 8000 Kbps, which the pin would refuse."""
    from repro_torch.core.scheduler import SystemConfig
    from repro_torch.data.synthetic import SceneConfig
    return SystemConfig(scene=SceneConfig(seed=33, num_cameras=num_cameras),
                        episode=True, eval_frames=3,
                        w_cap_kbps=W_CAP_KBPS * max(1.0, num_cameras / 5),
                        shard="on" if launched else "auto")


def server_detector(name: str, device):
    """The fleet's server detector: ``conv4``, the committed
    ``artifacts/detector_server`` weights, or ``yolov8s``, Ultralytics
    YOLOv8s at 384 x 640 with its seeded weights
    (``models.yolov8.build_server``, the ``deepstream_c16_yolov8s``
    benchmark configuration's settings)."""
    if name == "conv4":
        from repro_torch.models.detector import load_detector
        return load_detector("server", device)
    from repro_torch.models.yolov8 import build_server
    return build_server(device)


def run_fleet_stream(args) -> None:
    """Windowed fleet serving of the soak stream: build the episode-mode
    system, restore if ``--ckpt-dir`` holds a checkpoint, offer the stream
    window by window, and print the serving stats."""
    from repro_torch.common import prng
    from repro_torch.core import utility as util_mod
    from repro_torch.core.scheduler import DeepStreamSystem
    from repro_torch.data.scenarios import make_soak_stream
    from repro_torch.data.synthetic import DeviceScene
    from repro_torch.models.detector import load_detector
    from repro_torch.serve import ingest as ingest_mod
    from repro_torch.serve.stream import StreamConfig, StreamingFleetRunner

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import rules

    if args.trace:
        trace.enable()
    launched = mesh_mod.under_launcher()
    if launched:
        mesh_mod.init_distributed("cpu" if args.device == "cpu" else "cuda")
    dev = resolve_device(args.device)
    sys_cfg = fleet_system_config(args.num_cameras, launched)
    scene_cfg = sys_cfg.scene
    system = DeepStreamSystem(sys_cfg, load_detector("light", dev),
                              server_detector(args.server_detector, dev),
                              device=dev)
    mesh = system.mesh
    say = print if rules.is_writer(mesh) else (lambda *a, **k: None)
    system.mlp = util_mod.init_utility_mlp(prng.PRNGKey(0, device=dev))
    system.tau_wl, system.tau_wh = 10.0, 50.0
    system.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(
        np.float32)
    trace_kbps, live = make_soak_stream(args.stream_slots,
                                        num_cams=scene_cfg.num_cameras)
    runner = StreamingFleetRunner(
        system, DeviceScene(scene_cfg, device=dev, mesh=mesh),
        method=args.method,
        cfg=StreamConfig(window_slots=args.window_slots,
                         ckpt_dir=args.ckpt_dir, ckpt_keep=args.ckpt_keep,
                         install_signal=args.ckpt_dir is not None))
    with runner:
        if runner.restore():
            say(f"# restored window={runner.window} t_next={runner.t_next}")
        if args.source:
            if args.source.startswith("file:"):
                src = ingest_mod.FileTailSource(args.source[len("file:"):])
            else:
                host, _, port = args.source.rpartition(":")
                src = ingest_mod.SocketLineSource(host or "127.0.0.1",
                                                  int(port))
            ing = ingest_mod.StreamIngestor(runner, src)
            ing.pump(until_t=args.stream_slots, flush=True)
        else:
            t = runner.t_next
            while t < len(trace_kbps):
                t += runner.offer(trace_kbps[t:t + args.window_slots],
                                  faults=live[t:t + args.window_slots])
                runner.serve()
            runner.serve(flush=True)
        say({k: round(v, 4) if isinstance(v, float) else v
             for k, v in runner.stats().items()})
        if args.trace:
            for name, row in span_summary().items():
                say(f"# span {name} {row}")
            for name, n in sorted(trace.counts().items()):
                say(f"# count {name} {n}")
    if launched:
        mesh_mod.shutdown()


def run_lm(args) -> None:
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Request, ServeEngine

    mesh = None
    if mesh_mod.under_launcher():
        mesh_mod.init_distributed("cpu" if args.device == "cpu" else "cuda")
        mesh = (mesh_mod.make_host_mesh()
                if torch.distributed.get_world_size() == 1
                else mesh_mod.make_production_mesh(model=args.model))
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg, mesh)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(lm, params, batch_slots=args.slots,
                      max_seq=args.max_seq, device=dev)
    stats = eng.run(reqs)
    if mesh is None or mesh.rank == 0:
        print({k: round(v, 3) if isinstance(v, float) else v
               for k, v in stats.items()})
    if mesh is not None:
        mesh_mod.shutdown()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--model", type=int, default=None,
                    help="LM engine under torchrun: ranks of the mesh's "
                         "model axis (default: the ranks of one node)")
    ap.add_argument("--fleet-stream", action="store_true",
                    help="serve the multi-camera fleet stream "
                         "(serve.stream) instead of the LM engine")
    ap.add_argument("--stream-slots", type=int, default=64)
    ap.add_argument("--window-slots", type=int, default=8)
    ap.add_argument("--method", default="deepstream")
    ap.add_argument("--server-detector", choices=("conv4", "yolov8s"),
                    default="conv4",
                    help="the fleet stream's server detector (conv4: the "
                         "committed weights; yolov8s: seeded, 384 x 640)")
    ap.add_argument("--num-cameras", type=int, default=5,
                    help="cameras of the fleet stream")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-keep", type=int, default=None,
                    help="retention: keep the newest N checkpoint "
                         "generations (never the newest valid one)")
    ap.add_argument("--trace", action="store_true",
                    help="record the fleet stream's spans and print each "
                         "span's count, p50 and p95")
    ap.add_argument("--source", default=None,
                    help="hardened ingest source: file:PATH (tail a "
                         "line-protocol file) or HOST:PORT (TCP)")
    args = ap.parse_args(argv)
    if args.fleet_stream:
        run_fleet_stream(args)
        return
    if not args.arch:
        ap.error("--arch is required for the LM engine "
                 "(or pass --fleet-stream)")
    run_lm(args)


if __name__ == "__main__":
    main()
