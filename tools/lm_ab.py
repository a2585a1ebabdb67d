#!/usr/bin/env python3
"""ms per decode call of granite-8b at its published width for one source
tree, to compare two trees on one CUDA card.

Run from the repository root, once per tree and in turns (A, B, B, A),
one after another on one card:

    git archive <parent> | tar -x -C build/parent     # build/ is ignored
    for t in build/parent . . build/parent; do
        python3 tools/lm_ab.py $t; done

``repro_torch`` is imported from ``<tree>/src`` (its kernels build into
``<tree>/build/kernels``).  granite-8b (36 layers, bf16, seeded random
weights from ``torch.Generator(device="cuda").manual_seed(0)``), a
prefill of 4 rows of 512 seeded tokens into a cache of 2048 positions,
then 5 warm-up decode calls and 30 timed ones at positions 512.. for
every row, then 30 that write rows 0 and 1 only (the engine's grouped
decode), each call timed on the host clock between two synchronizes.
Prints the card's name and power limit, then one line per tree: the
median, min and max ms per call of each kind.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

ROWS, PROMPT, MAX_SEQ, WARM, TIMED = 4, 512, 2048, 5, 30


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else ".").resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import LM
    if not torch.cuda.is_available():
        print("lm_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    dev = torch.device("cuda")
    cfg = get_config("granite-8b")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (ROWS, PROMPT + WARM + 2 * TIMED),
                           generator=g, device=dev)
    with torch.no_grad():
        _, cache = lm.prefill(params, {"tokens": tokens[:, :PROMPT]}, MAX_SEQ)
        out = {}
        pos = PROMPT
        for kind, rows, n in (("warm-up", None, WARM), ("all rows", None,
                                                         TIMED),
                              ("rows 0, 1", [0, 1], TIMED)):
            ms = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lm.decode(params, tokens[:, pos:pos + 1], cache, pos,
                          rows=rows)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                pos += 1
            out[kind] = ms
    print(f"{root}: granite-8b decode ms per call "
          + "; ".join(f"{k} median {statistics.median(v):.3f} (min "
                      f"{min(v):.3f}, max {max(v):.3f})"
                      for k, v in out.items() if k != "warm-up"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
