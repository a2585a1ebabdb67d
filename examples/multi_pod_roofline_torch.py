"""One cell's per-rank dry run and analytic roofline on the production
meshes, for the PyTorch port on H100 cards.

    PYTHONPATH=src python examples/multi_pod_roofline_torch.py \
        [--arch yi-34b] [--shape decode_32k]

The counterpart of ``multi_pod_roofline.py``.  JAX lowers the cell for
512 fake host devices and reads its roofline from XLA's compiled program;
the port has no XLA program and runs one process per card, so it takes
the meshes as stand-ins (axis names and sizes: the single (16 x 16)
("data", "model") mesh and the multi-pod (2 x 16 x 16) ("pod", "data",
"model") one) and reports, for each, one rank's bytes from
``repro_torch.launch.dryrun`` (its pieces of the weights, of the AdamW
state or of the cache, under JAX's sharding rules) and the analytic
roofline terms of ``repro_torch.roofline.analytic`` with the H100's
constants (``common.config.H100_SXM``: bf16 tensor-core peak, HBM3 and
NVLink rates).  Nothing here runs on a card or was measured: the numbers
are closed-form.
"""
import argparse
import json
from typing import Dict, List, Optional

from repro_torch.common.config import H100_SXM, SHAPES_BY_NAME
from repro_torch.launch import dryrun
from repro_torch.launch.specs import arch_run_config
from repro_torch.roofline.analytic import MeshDims, analytic_terms

MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def report(arch: str, shape: str, mesh: str) -> Dict:
    """The per-rank dry run and the H100 roofline of one cell on one of
    the production meshes."""
    dims = MESHES[mesh]
    chips = 1
    for n in dims:
        chips *= n
    tp = dims[-1]
    res = dryrun.run_cell(arch, shape, mesh=dims)
    if res["status"] != "ok":
        return res
    run = arch_run_config(arch, shape, mesh)
    terms = analytic_terms(run.model, SHAPES_BY_NAME[shape],
                           run.microbatches,
                           MeshDims(chips=chips, tp=tp, dp=chips // tp),
                           H100_SXM)
    return {**res, "mesh": mesh, "chips": chips, "roofline": terms}


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--shape", default="decode_32k")
    args = ap.parse_args(argv)
    out = {}
    for mesh in MESHES:
        print(f"== {args.arch} x {args.shape} on the {mesh} mesh "
              f"{'x'.join(map(str, MESHES[mesh]))} (H100 stand-ins) ==")
        r = out[mesh] = report(args.arch, args.shape, mesh)
        if r["status"] != "ok":
            print(f"  skipped: {r['reason']}")
            continue
        pr, t = r["per_rank"], r["roofline"]
        print(f"  per rank: weights {pr['weights_bytes'] / 1e9:.3f} GB, "
              f"adamw {pr['adamw_bytes'] / 1e9:.3f} GB, cache "
              f"{pr['cache_bytes'] / 1e9:.3f} GB, total "
              f"{pr['total_bytes'] / 1e9:.3f} GB of "
              f"{pr['hbm_bytes'] / 1e9:.0f} GB (fits: {pr['fits']})")
        print(f"  roofline: compute {t['a_compute_s'] * 1e3:.4f} ms, memory "
              f"{t['a_memory_s'] * 1e3:.4f} ms, collective "
              f"{t['a_collective_s'] * 1e3:.4f} ms -> bottleneck="
              f"{t['a_bottleneck']} step={t['a_step_s'] * 1e3:.4f}ms "
              f"fraction={t['a_fraction']:.3f}\n")
    print(json.dumps({m: {"per_rank_total_bytes": r.get("per_rank", {}).get(
        "total_bytes"), "roofline": r.get("roofline")}
        for m, r in out.items()}))
    return out


if __name__ == "__main__":
    main()
