"""Dry run: the device memory a (arch x shape cell) needs, from shapes
alone and, with ``trace``, from one rank's step traced on fake tensors.

The counterpart of ``repro.launch.dryrun``.  For a cell that
``specs.cell_supported`` admits it sums, from tensors on the meta device
(nothing is allocated):

  * the weights (``LM.param_defs`` at the config's dtypes);
  * the AdamW state of a train cell (``optimizer.abstract_opt_state`` at
    the config's ``MOMENT_DTYPE``: two moments and the step);
  * the cache of a prefill or decode cell (``LM.cache_defs`` at the
    cell's batch and length);

and holds the total against ``H100_SXM.hbm_bytes``, at the published
depth and, with ``layers``, at a cut depth (``num_layers`` replaced, as
``chip_smoke.py`` cuts a config).  These shapes-only figures leave out
activations, gradients and workspace.

With ``mesh`` (``--mesh 1x4``: data x model, or pod x data x model) it
also reports what each rank of that LM mesh holds: every leaf's piece
under ``sharding.rules.param_pspecs`` (the config's policy), the AdamW
moments in the same layout and the step, and the cache under
``launch.specs.cache_specs``; a leaf no axis cuts counts whole on every
rank.  The mesh is a stand-in of axis names and sizes: nothing is
started.

With ``trace`` (``--trace``) the cell is also traced, JAX's lowering and
compiling half: rank 0 of a world of the mesh's size on a fake process
group (``launch.mesh.fake_world``; ``16x16`` and ``2x16x16`` are JAX's
production meshes, no mesh a one-rank world) runs the cell's step
(``specs.build_cell``) once on fake tensors under
``analysis.trace_cost.trace``, which counts what the step allocates,
computes and communicates, activations, gradients and the kernels'
workspace included.  The artifact then carries JAX's ``memory`` (the
peak of the rank's live bytes), ``cost``, ``collectives`` and
``roofline`` (``roofline.analysis.roofline_terms`` with ``H100_SXM``)
blocks, ``devices``, ``meta``, the kernels' ``launches`` and
``trace_s`` (JAX's ``lower_s`` + ``compile_s``), and ``trace_device``.
A trace allocates nothing on a card, but its fake tensors take the
card's device type, so it runs where a card is and raises elsewhere
unless the caller asks for the CPU (``device="cpu"``, ``--device cpu``:
CPU-typed fake tensors).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k [--layers 8] [--mesh 1x4] [--trace [--device cpu]]
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
import types
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.common.config import (H100_SXM, SHAPES_BY_NAME, ModelConfig,
                                       OptimizerConfig)
from repro_torch.common.device import resolve_device
from repro_torch.common.params import abstract_params, map_defs
from repro_torch.launch.specs import (arch_run_config, cache_specs,
                                      cell_supported)
from repro_torch.sharding import rules as R
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


def stand_in_mesh(shape: Sequence[int]):
    """A mesh of axis names and sizes for the layout rules: (data, model)
    or (pod, data, model)."""
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                        "model")
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, map(int, shape))))


def _local_bytes(shape, dtype: torch.dtype, spec, mesh) -> int:
    n = 1
    for d in R.local_shape(shape, spec, mesh):
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def cache_pieces(lm: LM, batch: int, max_seq: int, mesh
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """One rank's piece of every leaf of ``lm``'s cache of ``batch`` rows
    for ``max_seq`` under ``launch.specs.cache_specs`` (JAX's rule), by
    dotted leaf path: (local shape, dtype)."""
    out = {}

    def walk(c, sp, path):
        if isinstance(c, tuple):
            out[path] = (R.local_shape(c[0], sp, mesh), c[1])
            return
        for k in c:
            walk(c[k], sp[k], f"{path}.{k}" if path else k)
    walk(lm.cache_defs(batch, max_seq),
         cache_specs(lm, batch, max_seq, mesh), "")
    return out


def cache_bytes_per_rank(lm: LM, batch: int, max_seq: int, mesh) -> int:
    """Bytes of one rank's pieces of ``lm``'s cache (``cache_pieces``)."""
    n = 0
    for shape, dt in cache_pieces(lm, batch, max_seq, mesh).values():
        k = torch.empty((), dtype=dt).element_size()
        for d in shape:
            k *= d
        n += k
    return n


def memory_per_rank(cfg: ModelConfig, shape: str, moment_dtype: str,
                    mesh) -> Dict[str, Any]:
    """Bytes one rank of ``mesh`` holds: its pieces of the weights, of
    the AdamW moments (and the step) of a train cell, and of the cache of
    a prefill or decode cell."""
    cell = SHAPES_BY_NAME[shape]
    lm = LM(cfg)
    defs = lm.param_defs()
    specs = R.param_pspecs(defs, mesh, cfg.fsdp_over_pod, cfg.parallelism)
    w, m = [], []
    mdt = getattr(torch, moment_dtype)

    def leaf(d):
        spec = R.safe_spec(d.shape, R.spec_for(
            d, mesh, cfg.fsdp_over_pod, cfg.parallelism), mesh)
        w.append(_local_bytes(d.shape, d.dtype, spec, mesh))
        m.append(_local_bytes(d.shape, mdt, spec, mesh))
        return spec
    assert map_defs(leaf, defs) == specs
    out = {"mesh": dict(mesh.shape), "policy": cfg.parallelism,
           "weights_bytes": sum(w), "adamw_bytes": 0, "cache_bytes": 0}
    if cell.kind == "train":
        out["adamw_bytes"] = 2 * sum(m) + 4       # m, v and the int32 step
    else:
        out["cache_bytes"] = cache_bytes_per_rank(
            lm, cell.global_batch, cell.seq_len, mesh)
    out["total_bytes"] = (out["weights_bytes"] + out["adamw_bytes"]
                          + out["cache_bytes"])
    out["hbm_bytes"] = int(H100_SXM.hbm_bytes)
    out["fits"] = out["total_bytes"] <= H100_SXM.hbm_bytes
    return out


def run_cell(arch: str, shape: str, layers: Optional[int] = None,
             mesh: Optional[Sequence[int]] = None, trace: bool = False,
             device=None) -> dict:
    """The dry run of one cell: ``published`` at the config's depth and,
    when ``layers`` is given, ``cut`` at that depth; with ``mesh`` (a
    data x model shape) also ``per_rank`` at the published depth (and
    ``cut_per_rank``); with ``trace`` also ``trace_cell``'s blocks at the
    published depth on ``mesh`` (default: one rank)."""
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
    if mesh is not None:
        m = stand_in_mesh(mesh)
        res["per_rank"] = memory_per_rank(run.model, shape,
                                          run.opt.moment_dtype, m)
        if layers is not None:
            res["cut_per_rank"] = memory_per_rank(
                run.model.replace(num_layers=layers), shape,
                run.opt.moment_dtype, m)
    if trace:
        res.update(trace_cell(arch, shape, tuple(mesh or (1, 1)),
                              device=device))
        res["activations"] = "traced"
    return res


def trace_cell(arch: str, shape: str, mesh: Sequence[int], *,
               device=None, run=None, cell=None) -> Dict[str, Any]:
    """One cell traced on rank 0 of a fake world of ``mesh``'s shape
    (``run`` / ``cell`` replace the config's run and shape cell, as
    ``specs.build_cell``'s): JAX's ``memory``, ``cost``, ``collectives``
    and ``roofline`` blocks, ``devices``, ``meta``, ``launches``,
    ``donated``, ``ops``, ``trace_s`` and ``trace_device`` (``device``'s
    type: the card's unless the caller asks for the CPU).  Starts and
    ends the fake group (none may be up)."""
    from repro_torch.analysis import trace_cost
    from repro_torch.launch.mesh import fake_world, shutdown
    from repro_torch.launch.specs import build_cell
    from repro_torch.roofline.analysis import roofline_terms
    device = resolve_device(device)
    lm_mesh = fake_world(tuple(mesh))
    try:
        fn, args, meta = build_cell(arch, shape, lm_mesh, device=device,
                                    run=run, cell=cell)
        res = trace_cost.trace(fn, *args)
        del fn, args
    finally:
        shutdown()
    res.pop("out")
    return {"devices": lm_mesh.size(), "meta": meta,
            "memory": res["memory"], "cost": res["cost"],
            "collectives": res["collectives"],
            "roofline": roofline_terms(res["cost"], res["collectives"]),
            "launches": res["launches"], "donated": res["donated"],
            "ops": res["ops"], "trace_s": round(res["trace_s"], 2),
            "trace_device": device.type}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--layers", type=int, default=None,
                    help="also report the cell at this depth")
    ap.add_argument("--mesh", default=None,
                    help="also report one rank of this LM mesh: DxM "
                         "(data x model) or PxDxM")
    ap.add_argument("--trace", action="store_true",
                    help="also trace rank 0's step on a fake world of "
                         "the mesh (JAX's memory, cost and collectives)")
    ap.add_argument("--device", default=None,
                    help="the traced tensors' device type (default: the "
                         "card's; cpu on a host without one)")
    ap.add_argument("--out", default=None,
                    help="also write the result to this JSON file "
                         "(with --trace, by default the sweep's artifact)")
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
    from repro_torch.launch import sweep
    mesh = sweep.mesh_shape(args.mesh) if args.mesh else None
    out = args.out
    if out is None and args.trace:
        out = sweep.artifact(args.arch, args.shape,
                             sweep.mesh_name(args.mesh or "1x1"))
    try:
        res = run_cell(args.arch, args.shape, args.layers, mesh,
                       trace=args.trace, device=args.device)
    except Exception as e:      # the cell's failure is its record
        res = {"arch": args.arch, "shape": args.shape, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0 if res["status"] in ("ok", "skip") else 1


if __name__ == "__main__":
    sys.exit(main())
