"""End-to-end LM training launcher (``repro.launch.train`` in PyTorch).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \
        --smoke [--device cpu] --steps 20 --batch 8 --seq 128

Wires: config -> LM -> data pipeline (prefetch) -> train step (parameters
and optimizer state updated in place) -> watchdog -> async checkpointing
(atomic, in the JAX package's format 2).  Every config of
``repro_torch.configs`` trains; the vlm's batches get zero image
embeddings and the audio family's zero encoder embeddings, as in the JAX
launcher.  ``--smoke`` runs the reduced config of the same family;
without it the published config runs, which at full depth needs more
memory than one card has for most architectures.  Without ``--device`` it runs on the card and raises if
there is none.  ``--resume`` restores the newest committed
``step_*`` checkpoint under ``--ckpt-dir``, the JAX launcher's too.
Each step waits on the card once, to print its metrics.

Under ``torchrun`` (one process per card) the launcher joins the process
group and trains on the LM mesh (``launch.mesh``): a one-rank world on
``make_host_mesh()``, a larger one on ``make_production_mesh()`` ("model"
over ``--model`` ranks, default the ranks of one node; "data" over the
rest)::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch granite-8b --model 4 ...

Each rank holds its pieces of the weights and AdamW state and its rows of
each batch; the checkpoints hold whole arrays (rank 0 writes, any mesh
or none restores them) and only rank 0 prints.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--model", type=int, default=None,
                    help="under torchrun: ranks of the mesh's model axis "
                         "(default: the ranks of one node)")
    args = ap.parse_args(argv)

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.common.config import OptimizerConfig, RunConfig
    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                           SyntheticTokenSource)
    from repro_torch.ft.watchdog import PreemptionCheckpointer, Watchdog
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import OptState, init_opt_state
    from repro_torch.train.steps import make_train_step

    mesh = None
    if mesh_mod.under_launcher():
        mesh_mod.init_distributed("cpu" if args.device == "cpu" else "cuda")
        mesh = (mesh_mod.make_host_mesh()
                if torch.distributed.get_world_size() == 1
                else mesh_mod.make_production_mesh(model=args.model))
    say = print if mesh is None or mesh.rank == 0 else (
        lambda *a, **k: None)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 2),
                          total_steps=args.steps)
    run = RunConfig(model=cfg, opt=opt, microbatches=args.microbatches)
    lm = LM(cfg, mesh)
    train_step = make_train_step(lm, run, donate=True)

    params = lm.init(torch.Generator(device=dev).manual_seed(run.seed))
    opt_state = init_opt_state(opt, params)
    # the specs of (params, opt_state) on the mesh: the moments share the
    # parameters' layout, the step is whole
    placements = (None if mesh is None else
                  (lm.specs, OptState((), lm.specs, lm.specs)))
    start_step = 0

    saver = ckpt.AsyncSaver()
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt_dir and args.resume:
        latest = ckpt.latest_committed(ckpt_dir)
        if latest is not None:
            (params, opt_state), meta = ckpt.restore(
                latest, (params, opt_state), mesh=mesh,
                placements=placements)
            start_step = int(meta["step"])
            say(f"resumed from {latest} at step {start_step}")

    def save(step: int) -> None:
        if not ckpt_dir:
            return
        path, meta = ckpt_dir / f"step_{step:08d}", {"arch": args.arch}
        if mesh is None:
            saver.save((params, opt_state), path, step=step, metadata=meta)
        else:
            ckpt.save((params, opt_state), path, step=step, metadata=meta,
                      mesh=mesh, placements=placements)

    pc = PreemptionCheckpointer(save, every=args.ckpt_every,
                                install_signal=False)
    wd = Watchdog()

    src = SyntheticTokenSource(DataConfig(args.batch, args.seq,
                                          cfg.vocab_size))
    loader = PrefetchLoader(src, dev, mesh, cfg.parallelism)
    it = iter(loader)
    embed_dtype = getattr(torch, cfg.dtype)
    for step in range(start_step, args.steps):
        batch = next(it)
        rows = batch["tokens"].shape[0]
        if cfg.family == "vlm":
            batch["img_embeds"] = torch.zeros(
                (rows, cfg.vlm.num_image_tokens, cfg.d_model),
                dtype=embed_dtype, device=dev)
        if cfg.family == "audio":
            batch["enc_embeds"] = torch.zeros(
                (rows, args.seq, cfg.d_model), dtype=embed_dtype,
                device=dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss, gnorm, lr = torch.stack([metrics["loss"], metrics["grad_norm"],
                                       metrics["lr"]]).tolist()
        dt = time.perf_counter() - t0
        status = wd.record(step, dt)
        pc.maybe_save(step)
        say(f"step {step:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
            f"lr={lr:.2e} {dt*1e3:7.1f}ms [{status}]", flush=True)
    save(args.steps)
    saver.wait()
    loader.close()
    if mesh is not None:
        mesh_mod.shutdown()


if __name__ == "__main__":
    main()
