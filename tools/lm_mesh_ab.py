#!/usr/bin/env python3
"""The LM on a (data, model) mesh of several cards against one card.

Run from the repository root on a machine with N cards:

    python3 tools/lm_mesh_ab.py --ranks 4 [--layers 36]
    python3 tools/lm_mesh_ab.py --ranks 4 --arch olmoe-1b-7b [--layers 16]

The script builds the kernels and starts ``python -m
torch.distributed.run --standalone --nproc-per-node N`` on itself; every
rank joins an NCCL group and:

  * **trains** granite-8b at its published width (bf16 weights, float32
    AdamW moments, remat minimal) at ``--layers`` of its 36 layers, one
    step of 4 rows of 4096 tokens in 2 microbatches, on each mesh of
    ``meshes(N)`` ((1, 4) and (2, 2) for 4 ranks): the weights are the
    unsharded model's seeded numbers (``LM.init`` keeps each rank's
    piece), a warm-up step, then ``TIMED`` steps timed with CUDA events
    (the ranks start together).  Printed per mesh: the loss of the first
    step, ms/step (median), MFU per card (6 N_matmul + 12 L H hd S FLOPs
    a token, as ``chip_smoke.py`` counts them, over the card's dense bf16
    peak, divided by N) and the peak memory of the fullest card;
  * **serves** phase 7's requests (6 prompts of 512/512/384/384/512/256
    tokens, 16 new each, 4 slots, max_seq 2048) at ``--layers`` layers,
    first on rank 0's card alone (unsharded), then on the (1, N) mesh
    (tensor parallelism over N, the cache's sequence cut over "model",
    flash-decode on each rank's slice): the tokens must be equal, and the
    ms per decode call (median over the engine's decode calls) of each
    side is printed.

``--arch olmoe-1b-7b`` runs the MoE the same way with expert
parallelism over "model": one mesh, (1, N), so the 64 experts are cut
N ways; at its published 16 layers the weights and AdamW state are
69.20 GB, about 17.3 GB a card on 4 (the train step's MFU counts the
active parameters: each token's top-8 of 64 experts); then the engine
on one card against the (1, N) mesh.  Its capacity is JAX's per rank
(``_capacity(n_loc, top_k, N, cf)``), so an unbalanced router can drop
pairs on the mesh that one card keeps: the tokens are compared and
reported, and only the granite run fails on a difference.

Then the **long-context** case, for granite-8b (2 of its 36 layers) and
seamless-m4t-large-v2 (2 encoder and 2 decoder layers, at the LM level):
one request of ``LONG_PROMPT`` tokens (seamless: with seeded encoder
states over all ``LONG_SEQ`` positions) at batch 1, prefilled and
decoded ``LONG_NEW`` times on rank 0's card alone, then on the (N, 1)
mesh, where the 4 "data" ranks do not divide the batch: every rank
holds the row and a quarter of the positions of the self caches (and
of seamless's cross cache), B4 runs on each rank's range and the
ranges are merged over "data".  Each rank's allocated cache bytes must
equal the dry run's per-rank figure (``dryrun.cache_bytes_per_rank``,
JAX's ``cache_shardings``), and the logits are compared with one card's
(max |diff| over max |logit|, and the argmax of every call).

``--train-only`` runs the train steps alone.  ``--traced`` runs no
step: it traces rank 0's train step of each mesh of ``meshes(N)`` on
a fake world of N ranks (``launch.dryrun.trace_cell`` at the same
config, rows and microbatches, on fake tensors of ``--device``'s type;
one process a mesh, one card or none) and prints its peak and argument
bytes, what the ``--train-only`` run's per-card step peaks are held to.
``--smoke --device cpu``
runs the same on the CPU over gloo at the
arch's smoke width (a rehearsal, no timing worth reading).  It fails if
granite's tokens differ or a loss is not finite.  The card's name and
power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMED = 3
ROWS, SEQ, MICROBATCHES = 4, 4096, 2          # chip_smoke.py phase 10
PROMPTS = (512, 512, 384, 384, 512, 256)      # chip_smoke.py phase 7
NEW, SLOTS, MAX_SEQ = 16, 4, 2048
SMOKE = dict(rows=4, seq=32, prompts=(8, 8, 12, 12, 5, 8), new=6,
             max_seq=32)


ARCHS = {"granite-8b": 36, "olmoe-1b-7b": 16}     # published layers
# the long-context case: batch 1 on (N, 1), positions cut over "data"
LONG = (("granite-8b", {"num_layers": 2}),
        ("seamless-m4t-large-v2", {"encdec": (2, 2)}))
LONG_SEQ, LONG_PROMPT, LONG_NEW = 8192, 512, 8
SMOKE_LONG = dict(max_seq=64, prompt=8, new=4)


def meshes(n: int, arch: str = "granite-8b"):
    """(data, model) shapes timed for n ranks."""
    if arch != "granite-8b":
        return [(1, n)]
    return [(1, n)] + ([(2, n // 2)] if n >= 4 and n % 2 == 0 else [])


class Timed:
    """``lm`` with each decode call timed (synchronised on the card), and
    the whole logits of every prefill and decode kept (on the host)."""

    def __init__(self, lm, sync):
        self.lm, self.sync, self.ms, self.logits = lm, sync, [], []

    def __getattr__(self, name):
        return getattr(self.lm, name)

    def prefill(self, *a, **kw):
        out = self.lm.prefill(*a, **kw)
        self.logits.append(self.lm.full_logits(out[0])[:, -1].float().cpu())
        return out

    def decode(self, *a, **kw):
        self.sync()
        t0 = time.perf_counter()
        out = self.lm.decode(*a, **kw)
        self.sync()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.logits.append(self.lm.full_logits(out[0])[:, 0].float().cpu())
        return out


def divergence(one: list, mesh: list, vocab: int) -> dict:
    """Of the engine calls both sides made alike (in order), the largest
    |logit difference| over max |logit|; at the first call whose argmax
    differs in some row, that row's difference and the one card's margin
    between its two largest logits (a difference above the margin flips
    the token)."""
    worst, first = 0.0, None
    for i, (a, b) in enumerate(zip(one, mesh)):
        a, b = a[..., :vocab], b[..., :vocab]
        worst = max(worst, float((a - b).abs().max() / a.abs().max()))
        flip = (a.argmax(-1) != b.argmax(-1)).nonzero()
        if len(flip):
            r = int(flip[0][0])
            top = a[r].topk(2).values
            first = {"call": i, "row": r,
                     "diff": float((a[r] - b[r]).abs().max()),
                     "margin": float(top[0] - top[1])}
            break
    return {"max_rel_diff": worst, "first_flip": first}


def _config(args):
    from repro_torch.configs import get_config, smoke_config
    if args.smoke:
        return smoke_config(args.arch)
    return get_config(args.arch).replace(num_layers=args.layers)


def _flops_per_token(cfg, lm, seq: int) -> float:
    """6 N_matmul + 12 L H hd S (chip_smoke.py's MFU count), an expert
    matrix counted top_k / E times (the experts a token runs)."""
    import numpy as np
    from repro_torch.common.params import map_defs
    n = []
    act = (cfg.moe.top_k / cfg.moe.num_experts if cfg.family == "moe"
           else 1.0)
    map_defs(lambda d: n.append(
        int(np.prod(d.shape)) * (act if "experts" in d.logical_axes else 1)
        if len(d.shape) >= 2 else 0), lm.param_defs())
    n_mm = sum(n) - cfg.padded_vocab * cfg.d_model   # the input gather
    return (6 * n_mm + 12 * cfg.num_layers * cfg.num_heads
            * cfg.resolved_head_dim * seq)


def train(args, shape, dev, sync) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.common.config import (H100_SXM, OptimizerConfig,
                                           RunConfig)
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.steps import make_train_step

    rows, seq = ((SMOKE["rows"], SMOKE["seq"]) if args.smoke
                 else (ROWS, SEQ))
    cfg = _config(args)
    mesh = mesh_mod.lm_device_mesh(*shape)
    lm = LM(cfg, mesh)
    run = RunConfig(model=cfg, opt=OptimizerConfig(lr=1e-4, warmup_steps=1,
                                                   total_steps=10),
                    microbatches=MICROBATCHES)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(run.opt, params)
    step = make_train_step(lm, run, donate=True)
    src = SyntheticTokenSource(DataConfig(rows, seq, cfg.vocab_size))
    lo, hi = lm.batch_rows(rows)
    ms, losses = [], []
    for i in range(TIMED + 1):
        batch = {k: torch.as_tensor(v[lo:hi], device=dev).to(torch.int32)
                 for k, v in src.batch_at(i).items()}
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        sync()
        if i > 0:
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    peak = torch.tensor(float(torch.cuda.max_memory_allocated())
                        if dev.type == "cuda" else 0.0, device=dev)
    dist.all_reduce(peak, dist.ReduceOp.MAX)
    # one more step with the card's peak around it alone: the peak less
    # what was resident at entry but the step's arguments (what
    # ``launch.dryrun.trace_cell`` traces on a rank of a fake world)
    from repro_torch.launch.dryrun import tree_bytes
    batch = {k: torch.as_tensor(v[lo:hi], device=dev).to(torch.int32)
             for k, v in src.batch_at(TIMED + 1).items()}
    dist.barrier()
    sync()
    step_peak = 0.0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        entry = torch.cuda.memory_allocated()
    args_bytes = tree_bytes((params, opt, batch))
    params, opt, metrics = step(params, opt, batch)
    sync()
    if dev.type == "cuda":
        step_peak = float(torch.cuda.max_memory_allocated()
                          - (entry - args_bytes))
    per_rank = [torch.zeros((), dtype=torch.float64, device=dev)
                for _ in range(dist.get_world_size())]
    dist.all_gather(per_rank, torch.tensor(step_peak, dtype=torch.float64,
                                           device=dev))
    med = statistics.median(ms)
    flops = _flops_per_token(cfg, LM(cfg), seq) * rows * seq
    mfu = flops / (med / 1e3) / H100_SXM.peak_flops / mesh.size()
    del params, opt
    return {"mesh": shape, "layers": cfg.num_layers, "loss": losses[0],
            "losses": losses, "ms_per_step": med, "ms": ms, "mfu": mfu,
            "peak_bytes": int(peak), "finite": bool(np.isfinite(losses).all()),
            "step_peak_bytes": [int(x) for x in per_rank],
            "args_bytes": int(args_bytes)}


def trace_step(args, shape) -> dict:
    """Rank 0's train step of ``train`` on ``shape``, traced on a fake
    world of that shape (this process's only group)."""
    from repro_torch.common.config import (OptimizerConfig, RunConfig,
                                           ShapeCell)
    from repro_torch.launch.dryrun import trace_cell
    rows, seq = ((SMOKE["rows"], SMOKE["seq"]) if args.smoke
                 else (ROWS, SEQ))
    run = RunConfig(model=_config(args),
                    opt=OptimizerConfig(lr=1e-4, warmup_steps=1,
                                        total_steps=10),
                    microbatches=MICROBATCHES)
    res = trace_cell(args.arch, "lm_mesh_ab train", shape,
                     device=args.device, run=run,
                     cell=ShapeCell("lm_mesh_ab train", seq, rows, "train"))
    return {"mesh": list(shape), "layers": run.model.num_layers,
            "peak_bytes": res["memory"]["peak_estimate_bytes"],
            "args_bytes": res["memory"]["argument_bytes"],
            "trace_s": res["trace_s"], "device": res["trace_device"]}


def traced(args, tag: str) -> int:
    """``--traced``: ``trace_step`` of each mesh, one process each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for d, m in meshes(args.ranks, args.arch):
        cmd = [sys.executable, str(Path(__file__).resolve()),
               "--trace-shape", f"{d}x{m}", "--arch", args.arch,
               "--layers", str(args.layers), "--device", args.device,
               "--out", args.out] + (["--smoke"] if args.smoke else [])
        Path(args.out).unlink(missing_ok=True)
        if subprocess.run(cmd, env=env, cwd=ROOT, timeout=3000).returncode:
            print(f"lm_mesh_ab: the trace of (data {d}, model {m}) failed",
                  file=sys.stderr)
            return 1
        t = json.loads(Path(args.out).read_text())
        print(f"lm mesh traced {args.arch} ({t['layers']} layers) on (data "
              f"{d}, model {m}): rank 0's step peak {t['peak_bytes']} bytes,"
              f" {t['args_bytes']} argument bytes (fake tensors of device "
              f"type {t['device']}, traced in {t['trace_s']:.1f} s) {tag}")
    return 0


def serve(args, dev, sync) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Request, ServeEngine

    prompts, new, max_seq = ((SMOKE["prompts"], SMOKE["new"],
                              SMOKE["max_seq"]) if args.smoke
                             else (PROMPTS, NEW, MAX_SEQ))
    cfg = _config(args)

    def requests():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=new)
                for i, n in enumerate(prompts)]

    out = {}
    if dist.get_rank() == 0:             # one card, unsharded
        lm = Timed(LM(cfg), sync)
        params = lm.init(torch.Generator(device=dev).manual_seed(0))
        reqs = requests()
        ServeEngine(lm, params, SLOTS, max_seq, device=dev).run(reqs)
        out["one"] = ([r.out_tokens for r in reqs], lm.ms)
        one_logits = lm.logits
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    mesh = mesh_mod.lm_device_mesh(1, dist.get_world_size())
    lm = Timed(LM(cfg, mesh), sync)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    reqs = requests()
    ServeEngine(lm, params, SLOTS, max_seq, device=dev).run(reqs)
    out["mesh"] = ([r.out_tokens for r in reqs], lm.ms)
    if dist.get_rank() == 0:
        out["divergence"] = divergence(one_logits, lm.logits, cfg.vocab_size)
    return out


def _long_config(args, arch: str, over: dict):
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    if args.smoke:
        return smoke_config(arch)
    cfg = get_config(arch)
    if "encdec" in over:
        enc, dec = over["encdec"]
        return cfg.replace(encdec=dataclasses.replace(
            cfg.encdec, enc_layers=enc, dec_layers=dec))
    return cfg.replace(**over)


def long_context(args, dev, sync) -> dict:
    """Batch 1 on (N, 1): prefill and decodes on rank 0's card alone and
    on the mesh; each rank's cache bytes against the dry run's."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import LM

    max_seq, prompt, new = ((SMOKE_LONG["max_seq"], SMOKE_LONG["prompt"],
                             SMOKE_LONG["new"]) if args.smoke
                            else (LONG_SEQ, LONG_PROMPT, LONG_NEW))
    n = dist.get_world_size()
    out = {}
    for arch, over in LONG:
        cfg = _long_config(args, arch, over)
        g = torch.Generator().manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (1, prompt + new),
                            generator=g).to(dev)
        more = {}
        if cfg.family == "audio":
            more["enc_embeds"] = torch.randn(
                1, max_seq, cfg.d_model, generator=g).to(
                    dev, getattr(torch, cfg.dtype))

        def drive(lm, params, **kw):
            logits = []
            lg, cache = lm.prefill(params, {"tokens": tok[:, :prompt],
                                            **more}, max_seq, **kw)
            logits.append(lm.full_logits(lg)[:, -1].float().cpu())
            nbytes = dryrun.tree_bytes(cache)
            fd_ops.LAUNCHES = 0
            for i in range(prompt, prompt + new):
                lg, cache = lm.decode(params, tok[:, i:i + 1], cache, i,
                                      **kw)
                logits.append(lm.full_logits(lg)[:, 0].float().cpu())
            sync()
            return logits, nbytes, fd_ops.LAUNCHES

        res = {}
        if dist.get_rank() == 0:
            lm = LM(cfg)
            params = lm.init(torch.Generator(device=dev).manual_seed(0))
            res["one"], _, _ = drive(lm, params)
            del params
        dist.barrier()
        mesh = mesh_mod.lm_device_mesh(n, 1)
        lm = LM(cfg, mesh)
        params = lm.init(torch.Generator(device=dev).manual_seed(0))
        logits, nbytes, launches = drive(lm, params, global_batch=1)
        want = dryrun.cache_bytes_per_rank(
            LM(cfg), 1, max_seq, dryrun.stand_in_mesh((n, 1)))
        bad = torch.tensor([float(nbytes != want)], device=dev)
        dist.all_reduce(bad, dist.ReduceOp.MAX)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if dist.get_rank() == 0:
            one = res["one"]
            rel = max(float((a - b).abs().max() / a.abs().max())
                      for a, b in zip(one, logits))
            same = all(bool((a[..., :cfg.vocab_size].argmax(-1)
                             == b[..., :cfg.vocab_size].argmax(-1)).all())
                       for a, b in zip(one, logits))
            layers = (f"{cfg.encdec.enc_layers} + {cfg.encdec.dec_layers}"
                      if cfg.family == "audio" else cfg.num_layers)
            out[arch] = {"layers": layers, "max_seq": max_seq,
                         "prompt": prompt, "new": new,
                         "cache_bytes": nbytes, "dryrun_bytes": want,
                         "bytes_equal_on_every_rank": not bool(bad.item()),
                         "max_rel_diff": rel, "argmax_equal": same,
                         "b4_launches": launches}
    return out


def worker(args) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    mesh_mod.init_distributed(args.device)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {"train": [train(args, s, dev, sync)
                         for s in meshes(dist.get_world_size(), args.arch)]}
        if not args.train_only:
            res["serve"] = serve(args, dev, sync)
        if args.arch == "granite-8b" and not args.train_only:
            res["long"] = long_context(args, dev, sync)
        if dist.get_rank() == 0:
            Path(args.out).write_text(json.dumps(res))
    finally:
        mesh_mod.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--arch", default="granite-8b", choices=tuple(ARCHS))
    ap.add_argument("--layers", type=int, default=None,
                    help="layers (default: the published depth, granite-8b "
                         "36 and olmoe-1b-7b 16; one card holds granite's "
                         "weights and AdamW state of 8)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (a CPU rehearsal)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--train-only", action="store_true",
                    help="the train steps alone (no serving, no long "
                         "context)")
    ap.add_argument("--traced", action="store_true",
                    help="trace rank 0's train step of each mesh instead "
                         "(no step runs; one card or none)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--trace-shape", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=str(ROOT / "build" / "lm_mesh_ab.json"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.layers is None:
        args.layers = ARCHS[args.arch]
    if args.worker:
        return worker(args)
    sys.path.insert(0, str(ROOT / "src"))
    if args.trace_shape:
        shape = tuple(int(x) for x in args.trace_shape.split("x"))
        Path(args.out).write_text(json.dumps(trace_step(args, shape)))
        return 0
    import torch
    tag = "[cpu]"
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("lm_mesh_ab: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < args.ranks and not args.traced:
            print(f"lm_mesh_ab: {args.ranks} ranks need as many cards, this "
                  f"machine has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(" | ".join(smi.splitlines()))
        tag = f"[{smi.splitlines()[0]}]"
        if not args.traced:
            from repro_torch.kernels import build
            build.build()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if args.traced:
        return traced(args, tag)
    Path(args.out).unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(args.ranks), str(Path(__file__).resolve()),
           "--worker", "--arch", args.arch, "--layers", str(args.layers),
           "--device", args.device,
           "--out", args.out] + (["--smoke"] if args.smoke else []) + (
               ["--train-only"] if args.train_only else [])
    p = subprocess.run(cmd, env=env, cwd=ROOT, timeout=3000)
    if p.returncode != 0:
        print(f"lm_mesh_ab: the {args.ranks}-rank run failed",
              file=sys.stderr)
        return 1
    res = json.loads(Path(args.out).read_text())
    ok = True
    for t in res["train"]:
        d, m = t["mesh"]
        print(f"lm mesh train {args.arch} ({t['layers']} layers) on "
              f"(data {d}, model {m}): loss {t['loss']:.6f} (steps "
              f"{[round(x, 4) for x in t['losses']]}), ms/step median "
              f"{t['ms_per_step']:.1f} ({TIMED} steps "
              f"{[round(x, 1) for x in t['ms']]}), MFU per card "
              f"{100 * t['mfu']:.2f}%, peak memory of the fullest card "
              f"{t['peak_bytes'] / 2**30:.2f} GiB {tag}")
        print(f"lm mesh train {args.arch} on (data {d}, model {m}): one "
              f"step's peak a card (max_memory_allocated() less what was "
              f"resident at entry but the step's arguments; rank 0 "
              f"{t['args_bytes']} argument bytes) "
              f"{t['step_peak_bytes']} bytes {tag}")
        ok &= t["finite"]
    if args.train_only:
        return 0 if ok else 1
    (one, one_ms), (mesh, mesh_ms) = res["serve"]["one"], res["serve"]["mesh"]
    same = one == mesh
    differ = ("" if same else " (first at request, token " + str(next(
        (i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
        for i, (x, y) in enumerate(zip(one, mesh)) if x != y)) + ")")
    print(f"lm mesh serve {args.arch}: tokens of (1, {args.ranks}) "
          f"{'equal' if same else 'DIFFER from'} one card's{differ}; ms per "
          f"decode call median one card {statistics.median(one_ms):.3f} "
          f"({len(one_ms)} calls), mesh {statistics.median(mesh_ms):.3f} "
          f"({len(mesh_ms)} calls) {tag}")
    div = res["serve"]["divergence"]
    flip = div["first_flip"]
    print(f"lm mesh serve {args.arch}: max |logit diff| / max |logit| over "
          f"the calls made alike {div['max_rel_diff']:.4g}" + (
              "" if flip is None else
              f"; first flipped token at call {flip['call']} row "
              f"{flip['row']}: |diff| {flip['diff']:.4g} against the one "
              f"card's top-2 margin {flip['margin']:.4g}") + f" {tag}")
    for arch, lc in res.get("long", {}).items():
        print(f"lm mesh long context {arch} ({lc['layers']} layers, batch "
              f"1, {lc['prompt']} prompt tokens + {lc['new']} decodes, "
              f"max_seq {lc['max_seq']}) on (data {args.ranks}, model 1): "
              f"cache {lc['cache_bytes']} bytes a rank, the dry run's "
              f"{lc['dryrun_bytes']} "
              f"({'equal on every rank' if lc['bytes_equal_on_every_rank'] else 'DIFFERENT'}); "
              f"max |logit diff| / max |logit| vs one card "
              f"{lc['max_rel_diff']:.4g}, argmax "
              f"{'equal' if lc['argmax_equal'] else 'DIFFERS'} in every "
              f"call; flash_decode launches in the mesh's decodes "
              f"{lc['b4_launches']} {tag}")
        ok &= lc["bytes_equal_on_every_rank"]
        ok &= args.device != "cuda" or lc["b4_launches"] > 0
    if args.arch != "granite-8b":
        same = True
    if not (ok and same):
        print("lm_mesh_ab: a loss is not finite, the tokens differ or a "
              "rank's cache is not the dry run's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
