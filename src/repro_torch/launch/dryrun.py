"""One-card dry run: the device memory a (arch x shape cell) needs, from
shapes alone.

The counterpart of the memory side of ``repro.launch.dryrun``.  For a
cell that ``specs.cell_supported`` admits it sums, from tensors on the
meta device (nothing is allocated):

  * the weights (``LM.param_defs`` at the config's dtypes);
  * the AdamW state of a train cell (``optimizer.abstract_opt_state`` at
    the config's ``MOMENT_DTYPE``: two moments and the step);
  * the cache of a prefill or decode cell (``LM.cache_defs`` at the
    cell's batch and length);

and holds the total against ``H100_SXM.hbm_bytes``, at the published
depth and, with ``layers``, at a cut depth (``num_layers`` replaced, as
``chip_smoke.py`` cuts a config).  Activations, gradients and workspace
are not modelled: a cell that fits here may still not fit on the card.

JAX's lowering and compiling on 512 fake devices, ``memory_analysis()``,
``cost_analysis()`` and the collectives parsed from the HLO have no
counterpart: the port compiles no XLA program and has no mesh.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k [--layers 8]
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional

import torch

from repro_torch.common.config import (H100_SXM, SHAPES_BY_NAME, ModelConfig,
                                       OptimizerConfig)
from repro_torch.common.params import abstract_params
from repro_torch.launch.specs import arch_run_config, cell_supported
from repro_torch.models.model import LM
from repro_torch.train.optimizer import abstract_opt_state, tree_leaves


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of a nest of dicts, tuples and tensors."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(tree_bytes(x) for x in items)


def abstract_cache(lm: LM, batch: int, max_seq: int) -> Dict[str, Any]:
    """``LM.cache_defs`` as tensors on the meta device."""
    def meta(specs):
        if isinstance(specs, tuple):
            return torch.empty(specs[0], dtype=specs[1], device="meta")
        return {k: meta(v) for k, v in specs.items()}
    return meta(lm.cache_defs(batch, max_seq))


def memory(cfg: ModelConfig, shape: str, moment_dtype: str) -> Dict[str, Any]:
    """Bytes of the weights, the AdamW state (train) and the cache
    (prefill, decode) of one config at one cell, and their total against
    the card's memory."""
    cell = SHAPES_BY_NAME[shape]
    lm = LM(cfg)
    params = abstract_params(lm.param_defs())
    assert all(t.is_meta for t in tree_leaves(params))
    out = {"layers": cfg.num_layers, "weights_bytes": tree_bytes(params),
           "adamw_bytes": 0, "cache_bytes": 0}
    if cell.kind == "train":
        opt = abstract_opt_state(OptimizerConfig(moment_dtype=moment_dtype),
                                 params)
        out["adamw_bytes"] = tree_bytes(opt)
    else:
        out["cache_bytes"] = tree_bytes(abstract_cache(
            lm, cell.global_batch, cell.seq_len))
    out["total_bytes"] = (out["weights_bytes"] + out["adamw_bytes"]
                          + out["cache_bytes"])
    out["hbm_bytes"] = int(H100_SXM.hbm_bytes)
    out["fits"] = out["total_bytes"] <= H100_SXM.hbm_bytes
    return out


def run_cell(arch: str, shape: str, layers: Optional[int] = None) -> dict:
    """The dry run of one cell: ``published`` at the config's depth and,
    when ``layers`` is given, ``cut`` at that depth."""
    ok, why = cell_supported(arch, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "status": "skip",
                "reason": why}
    run = arch_run_config(arch, shape)
    res = {"arch": arch, "shape": shape, "status": "ok",
           "kind": SHAPES_BY_NAME[shape].kind,
           "microbatches": run.microbatches,
           "moment_dtype": run.opt.moment_dtype,
           "activations": "not modelled",
           "published": memory(run.model, shape, run.opt.moment_dtype)}
    if layers is not None:
        res["cut"] = memory(run.model.replace(num_layers=layers), shape,
                            run.opt.moment_dtype)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--layers", type=int, default=None,
                    help="also report the cell at this depth")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.configs import list_archs
    if args.list:
        for a in list_archs():
            for s in SHAPES_BY_NAME:
                print(f"{a} {s}")
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --list)")
    print(json.dumps(run_cell(args.arch, args.shape, args.layers)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
