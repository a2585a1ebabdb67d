"""The dry-run table and the roofline table, from the sweep's artifacts
and the analytic roofline.

The counterpart of ``repro.roofline.report``.  ``dryrun_table`` has a
row per arch x shape x mesh (``launch.sweep``'s artifacts under
``artifacts/dryrun_torch/``): the status, the GB of weights, AdamW state
and cache one card of the mesh holds and their total, whether that
fits in ``H100_SXM.hbm_bytes``, and the cell's total on one card and
whether it fits there; then JAX's columns from a traced artifact
(``sweep --trace``): the traced peak GB of a card, the collective GB a
card sends (the ring traffic of the traced collectives) and the trace's
seconds (JAX's compile seconds).  A cell that has not been traced keeps
its shapes-only row, its traced columns marked ``not traced`` (or
``timeout`` when its trace ran out of time); a peak traced on CPU-typed
fake tensors (``sweep --trace --device cpu``, a host without a card)
is marked ``(cpu)``.
``fit_table`` puts the totals on one card and on a card of each mesh
side by side, the traced peak of a card of each mesh, and the bottleneck
on each.  ``roofline_table(hw, mesh)`` has a row per arch x shape from
``roofline.analytic.analytic_terms``: compute, memory and collective
seconds, the bottleneck, the step seconds, the roofline fraction, the
traced collective seconds of the mesh's artifact beside the analytic
ones (JAX's "HLO coll s") and JAX's hint of what moves the dominant
term; ``main`` shows it at one card (``MeshDims(1, 1, 1)``: no
collective term) and at the sweep's mesh.

The analytic figures are bytes counted from shapes and seconds from the
``H100_SXM`` constants (989 TFLOP/s bf16 dense, 3.35 TB/s HBM, 450 GB/s
NVLink a direction, 80 GB), not measured on a card; the traced ones
come from one rank's step on fake tensors (``analysis.trace_cost``), not
measured either.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.common.config import H100_SXM, SHAPES_BY_NAME, HWConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import sweep
from repro_torch.launch.specs import arch_run_config, cell_supported
from repro_torch.roofline.analytic import MeshDims, analytic_terms

ONE_CARD = MeshDims(chips=1, tp=1, dp=1)
HINTS = {
    ("memory", "train"): "less remat re-read: policy tuning / fused blocks",
    ("memory", "prefill"): "larger attention chunks; bf16 intermediates",
    ("memory", "decode"): "cache-read bound: quantized (int8) KV cache",
    ("collective", "train"): "sequence-parallel norms (RS+AG instead of AR); larger microbatches",
    ("collective", "prefill"): "sequence-parallel attention; overlap AG with GEMMs",
    ("collective", "decode"): "smaller TP groups for kv; duplicate KV heads",
    ("compute", "train"): "already compute-bound: raise MFU via fusion",
    ("compute", "prefill"): "already compute-bound: raise MFU via fusion",
    ("compute", "decode"): "batch more streams per step",
}


def hw_label(hw: HWConfig) -> str:
    return (f"{hw.peak_flops / 1e12:g} TFLOP/s, {hw.hbm_bw / 1e12:g} TB/s "
            f"HBM, {hw.ici_bw / 1e9:g} GB/s link, {hw.hbm_bytes / 1e9:g} GB")


def _load(arch: str, shape: str, mesh: str) -> Optional[dict]:
    p = sweep.artifact(arch, shape, mesh)
    return json.loads(p.read_text()) if p.exists() else None


def traced_peak(d: dict) -> str:
    """The traced peak GB of a card, ``(cpu)`` when its fake tensors were
    CPU-typed."""
    cpu = " (cpu)" if d.get("trace_device") == "cpu" else ""
    return f"{d['memory']['peak_estimate_bytes'] / 1e9:.1f}{cpu}"


def traced_columns(d: Optional[dict]) -> str:
    """JAX's columns of a traced artifact: peak GB a card, collective GB
    a card, trace seconds (``not traced`` without a trace)."""
    if d is not None and d["status"] == "timeout":
        return "timeout | | "
    if d is None or "memory" not in d:
        return "not traced | | "
    coll = d["roofline"]["collective_traffic_per_chip"]
    return f"{traced_peak(d)} | {coll / 1e9:.2f} | {d['trace_s']:.0f}"


def dryrun_table(meshes: Sequence[str] = ("single", "multi", "1x4")) -> str:
    gb = lambda n: f"{n / 1e9:.2f}"            # noqa: E731
    out = ["| arch | shape | mesh | status | weights GB/card | AdamW GB/card "
           "| cache GB/card | total GB/card | fits a card | one-card GB "
           "| fits one card | traced peak GB/card | collective GB/card "
           "| trace s |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for arch in list_archs():
        for shape in SHAPES_BY_NAME:
            for mesh in meshes:
                d = _load(arch, shape, mesh)
                if d is None or d["status"] not in ("ok", "timeout"):
                    status = "MISSING" if d is None else d["status"]
                    out.append(f"| {arch} | {shape} | {mesh} | {status} "
                               "| | | | | | | | | | |")
                    continue
                r, one = d["per_rank"], d["published"]
                out.append(
                    f"| {arch} | {shape} | {mesh} | {d['status']} "
                    f"| {gb(r['weights_bytes'])} | {gb(r['adamw_bytes'])} "
                    f"| {gb(r['cache_bytes'])} | {gb(r['total_bytes'])} "
                    f"| {'yes' if r['fits'] else 'no'} "
                    f"| {gb(one['total_bytes'])} "
                    f"| {'yes' if one['fits'] else 'no'} "
                    f"| {traced_columns(d)} |")
    return "\n".join(out)


def fit_table(meshes: Sequence[str] = ("1x4", "single", "multi")) -> str:
    """A row per arch x shape: the total GB on one card and a card of
    each mesh (``*``: more than ``H100_SXM.hbm_bytes``), and the
    analytic bottleneck on one card and on each mesh."""
    head = " | ".join(f"GB/card {m}" for m in meshes)
    peaks = " | ".join(f"traced peak {m}" for m in meshes)
    doms = " | ".join(f"bound {m}" for m in meshes)
    out = [f"| arch | shape | GB one card | {head} | {peaks} "
           f"| bound one card | {doms} |",
           "|---|---|" + "---|" * (2 + 3 * len(meshes))]
    cap = H100_SXM.hbm_bytes
    gb = lambda n: f"{n / 1e9:.1f}" + ("*" if n > cap else "")  # noqa: E731
    one = {(a["arch"], a["shape"]): a["a_bottleneck"]
           for a in roofline_rows(H100_SXM, ONE_CARD)}
    on = {m: {(a["arch"], a["shape"]): a["a_bottleneck"]
              for a in roofline_rows(H100_SXM, sweep.mesh_dims(
                  sweep.mesh_shape(m)))} for m in meshes}
    for arch in list_archs():
        for shape in SHAPES_BY_NAME:
            cells = [_load(arch, shape, m) for m in meshes]
            if any(d is None or d["status"] not in ("ok", "timeout")
                   for d in cells):
                why = "skip" if all(d is not None and d["status"] == "skip"
                                    for d in cells) else "MISSING"
                out.append(f"| {arch} | {shape} | {why} |"
                           + " |" * (1 + 3 * len(meshes)))
                continue
            key = (arch, shape)
            out.append(
                f"| {arch} | {shape} "
                f"| {gb(cells[0]['published']['total_bytes'])} | "
                + " | ".join(gb(d["per_rank"]["total_bytes"]) for d in cells)
                + " | " + " | ".join(
                    traced_peak(d) if "memory" in d
                    else "timeout" if d["status"] == "timeout"
                    else "not traced" for d in cells)
                + f" | {one[key]} | "
                + " | ".join(on[m][key] for m in meshes) + " |")
    return "\n".join(out)


def roofline_rows(hw: HWConfig = H100_SXM, mesh: MeshDims = ONE_CARD
                  ) -> List[Dict]:
    """Every arch x shape: its ``analytic_terms`` at ``hw`` on ``mesh``
    (the microbatches of ``arch_run_config``) and whether
    ``cell_supported`` admits it."""
    rows = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape, cell in SHAPES_BY_NAME.items():
            run = arch_run_config(arch, shape)
            rows.append({"arch": arch, "shape": shape,
                         "supported": cell_supported(arch, shape)[0],
                         "kind": cell.kind,
                         **analytic_terms(cfg, cell, run.microbatches,
                                          mesh, hw)})
    return rows


def roofline_table(hw: HWConfig = H100_SXM, mesh: MeshDims = ONE_CARD,
                   traced: Optional[str] = None) -> str:
    """The analytic rows at ``hw`` on ``mesh``, with the traced
    collective seconds of the ``traced`` mesh's artifacts (``—`` on one
    card or where a cell is not traced)."""
    out = ["| arch | shape | compute s | memory s | collective s "
           "| bottleneck | step s | roofline frac | traced coll s "
           "| what moves the dominant term |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for a in roofline_rows(hw, mesh):
        if not a["supported"]:
            out.append(f"| {a['arch']} | {a['shape']} | — | — | — | skip "
                       "(full attention, see DESIGN Arch-applicability) "
                       "| — | — | — | — |")
            continue
        dom = a["a_bottleneck"]
        d = _load(a["arch"], a["shape"], traced) if traced else None
        coll = (f"{d['roofline']['collective_s']:.4f}"
                if d is not None and "roofline" in d else "—")
        out.append(
            f"| {a['arch']} | {a['shape']} | {a['a_compute_s']:.4f} "
            f"| {a['a_memory_s']:.4f} | {a['a_collective_s']:.4f} | {dom} "
            f"| {a['a_step_s']:.4f} | {a['a_fraction']:.3f} | {coll} "
            f"| {HINTS.get((dom, a['kind']), '')} |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single",
                    help="the roofline's second mesh: single, multi or DxM")
    ap.add_argument("--dryrun-meshes", nargs="*",
                    default=["single", "multi", "1x4"])
    args = ap.parse_args(argv)
    label = hw_label(H100_SXM)
    print(f"## Dry-run table (bytes from shapes; fits = at most "
          f"{H100_SXM.hbm_bytes / 1e9:g} GB, H100_SXM)\n")
    print(dryrun_table(args.dryrun_meshes))
    print("\n## What fits where (GB a card, * = over "
          f"{H100_SXM.hbm_bytes / 1e9:g} GB; analytic bottleneck, "
          f"H100_SXM constants: {label})\n")
    print(fit_table([m for m in ("1x4", "single", "multi")
                     if m in args.dryrun_meshes]))
    print(f"\n## Roofline table, one card (analytic, H100_SXM constants: "
          f"{label}; not measured)\n")
    print(roofline_table(H100_SXM, ONE_CARD))
    dims = sweep.mesh_dims(sweep.mesh_shape(args.mesh))
    print(f"\n## Roofline table, mesh {args.mesh} ({dims.chips} cards, "
          f"tp {dims.tp}; analytic, H100_SXM constants: {label}; "
          "not measured)\n")
    print(roofline_table(H100_SXM, dims, traced=args.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
