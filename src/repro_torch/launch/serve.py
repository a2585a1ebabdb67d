"""LM serving launcher: continuous-batched decode over a dense backbone.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        [--smoke] [--device cpu] --requests 6 --slots 4 --prompt-len 24 \
        --max-new 8

Weights are a random initialisation from seed 0, made on the device;
without ``--device`` it runs on the card and raises if there is none.
Prompts are random tokens from seed 0.  The fleet stream mode of the JAX
launcher (``--fleet-stream``) is not ported yet (``ROADMAP.md``, Queue A
item 9).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model import LM
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the same family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    lm = LM(cfg)
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
    print({k: round(v, 3) if isinstance(v, float) else v
           for k, v in stats.items()})


if __name__ == "__main__":
    main()
