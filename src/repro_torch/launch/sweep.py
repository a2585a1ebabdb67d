"""The dry-run sweep: every (arch x shape x mesh) cell of the port's dry
run, one JSON artifact a cell and one line a cell.

The counterpart of ``repro.launch.sweep``.  It covers every
``list_archs()`` x ``SHAPES_BY_NAME`` cell over the mesh kinds
``single`` (a (16, 16) mesh), ``multi`` ((2, 16, 16)) and ``both``,
as JAX's does, and the dry run's own ``DxM`` / ``PxDxM`` form (``1x4``:
one data rank, four "model" ranks).  Each cell's
``launch.dryrun.run_cell(arch, shape, mesh=...)`` goes to
``artifacts/dryrun_torch/<canonical>__<shape>__<mesh>.json``; a cell
whose artifact says ``ok`` or ``skip`` (and, with ``--trace``, holds a
trace) is reused unless ``--force``.  A skipped cell is one
``specs.cell_supported`` refuses; a cell that raises is written with
status ``error`` and its message, and runs again next time.
``--layers ARCH=L`` also reports that arch's cells at L layers (the dry
run's ``cut`` and ``cut_per_rank``), as ``chip_smoke.py`` holds the
depths its phases allocate.

Without ``--trace`` the sweep runs in one process: the shapes-only dry
run builds its tensors on the meta device, so no cell can take
another's memory or hang.  Its line: the status, the GB one card of the
mesh holds (weights, AdamW state and cache under the mesh's layout), the
GB of the whole cell on one card, and the dominant term of the analytic
roofline (``roofline.analytic.analytic_terms`` with the ``H100_SXM``
constants on the mesh's dims).

With ``--trace`` each cell also traces rank 0's step on a fake world of
the mesh (``dryrun --trace``), in a subprocess of its own with
``--timeout`` seconds, as JAX's ``run_one`` compiles each cell: a fake
process group is one per process, and a cell that runs out of time is
recorded as ``timeout`` with its shapes-only figures.  Cells run one
at a time, as JAX's do: which cells time out is then a property of the
cell and the host, not of how many traces share it.  Its line is
JAX's: ``peak=`` the traced peak GB of a card, ``dom=`` the
traced roofline's bottleneck, ``frac=`` its roofline fraction.  Every
line ends with JAX's ``SWEEP DONE: n ok, n skip, n failed / n cells``.

  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh both
  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh 1x4 --archs granite-8b
  PYTHONPATH=src python -m repro_torch.launch.sweep --mesh 1x4 --trace --device cpu [--timeout 900]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.common.config import H100_SXM, SHAPES_BY_NAME
from repro_torch.configs import canonical, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.specs import arch_run_config
from repro_torch.roofline.analytic import MeshDims, analytic_terms

REPO = Path(__file__).resolve().parents[3]
ARTIFACT_DIR = REPO / "artifacts" / "dryrun_torch"
MESHES = {"single": (16, 16), "multi": (2, 16, 16)}


def mesh_shape(mesh: str) -> Tuple[int, ...]:
    """A mesh kind (``single``, ``multi``) or ``DxM`` / ``PxDxM`` -> its
    axis sizes."""
    if mesh in MESHES:
        return MESHES[mesh]
    shape = tuple(int(x) for x in mesh.lower().split("x"))
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"mesh {mesh!r}: single, multi, DxM or PxDxM")
    return shape


def mesh_name(mesh: str) -> str:
    """The artifact name of a mesh: JAX's kind for its production meshes
    (``16x16`` is ``single``, ``2x16x16`` ``multi``), else as given."""
    shape = mesh_shape(mesh)
    return next((k for k, v in MESHES.items() if v == shape),
                "x".join(map(str, shape)))


def mesh_dims(shape: Sequence[int]) -> MeshDims:
    """The analytic roofline's dims of a (data, model) or (pod, data,
    model) mesh: every chip, "model" the tensor-parallel width."""
    chips = 1
    for n in shape:
        chips *= n
    return MeshDims(chips=chips, tp=shape[-1], dp=chips // shape[-1])


def artifact(arch: str, shape: str, mesh: str) -> Path:
    return ARTIFACT_DIR / f"{canonical(arch)}__{shape}__{mesh}.json"


def run_one(arch: str, shape: str, mesh: str, force: bool = False,
            layers: Optional[int] = None, trace: bool = False,
            timeout: float = 900, device: Optional[str] = None) -> dict:
    """One cell's dry run (with ``layers``, also at that depth: its
    ``cut`` and ``cut_per_rank``): its artifact when that says ``ok`` or
    ``skip`` and holds the cut (and the trace) asked for (unless
    ``force``), else ``dryrun.run_cell`` written there (status ``error``
    and the message when it raises); with ``trace`` run in a subprocess
    of ``timeout`` seconds (status ``timeout`` when it runs out)."""
    out = artifact(arch, shape, mesh)
    if out.exists() and not force:
        res = json.loads(out.read_text())
        if res.get("status") == "skip" or (
                res.get("status") == "ok" and (
                    layers is None
                    or res.get("cut", {}).get("layers") == layers)
                and (not trace or "memory" in res)):
            return res
    if trace:
        return _traced(arch, shape, mesh, out, layers, timeout, device)
    try:
        res = dryrun.run_cell(arch, shape, layers, mesh=mesh_shape(mesh))
    except Exception as e:      # a cell's failure is its record, not the sweep's
        res = {"arch": arch, "shape": shape, "status": "error",
               "error": f"{type(e).__name__}: {e}"}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return res


def _traced(arch: str, shape: str, mesh: str, out: Path,
            layers: Optional[int], timeout: float,
            device: Optional[str]) -> dict:
    """``dryrun --trace`` of one cell in a subprocess writing ``out``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh, "--trace", "--out",
           str(out)]
    cmd += ["--layers", str(layers)] if layers is not None else []
    cmd += ["--device", device] if device else []
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = time.time()
    if out.exists():
        out.unlink()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        res = timed_out(arch, shape, mesh, layers,
                        f"trace exceeded {timeout:g}s "
                        f"({time.time() - t0:.0f}s)")
    else:
        if out.exists():
            return json.loads(out.read_text())
        res = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
               "error": (proc.stderr or proc.stdout)[-2000:]}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return res


def timed_out(arch: str, shape: str, mesh: str, layers: Optional[int],
              why: str) -> dict:
    """The record of a cell whose trace ran out of time: its shapes-only
    dry run (the report keeps that row), status ``timeout`` and ``why``."""
    res = dryrun.run_cell(arch, shape, layers, mesh=mesh_shape(mesh))
    return dict(res, mesh=mesh, status="timeout", error=why)


def dominant(arch: str, shape: str, mesh: str) -> str:
    """The bottleneck of ``analytic_terms`` with ``H100_SXM`` on the
    mesh's dims."""
    run = arch_run_config(arch, shape)
    return analytic_terms(get_config(arch), SHAPES_BY_NAME[shape],
                          run.microbatches, mesh_dims(mesh_shape(mesh)),
                          H100_SXM)["a_bottleneck"]


def line(res: dict, mesh: str, secs: Optional[float] = None) -> str:
    status = res.get("status")
    extra = ""
    if status == "ok" and "memory" in res:
        r = res["roofline"]
        extra = (f"peak={res['memory']['peak_estimate_bytes'] / 1e9:7.1f}GB "
                 f"dom={r['bottleneck']:<12s} "
                 f"frac={r['roofline_fraction']:.3f} "
                 f"card={res['per_rank']['total_bytes'] / 1e9:.2f}GB")
    elif status == "ok":
        card = res["per_rank"]["total_bytes"] / 1e9
        one = res["published"]["total_bytes"] / 1e9
        extra = (f"card={card:9.2f}GB one-card={one:9.2f}GB "
                 f"dom={dominant(res['arch'], res['shape'], mesh)}")
    elif status in ("error", "timeout"):
        extra = str(res.get("error", ""))[:120].replace("\n", " ")
    dt = "" if secs is None else f"{secs:6.0f}s "
    return (f"[{mesh}] {res['arch']:24s} {res['shape']:12s} {status:7s} "
            f"{dt}{extra}")


def sweep(meshes: Sequence[str], archs: Optional[Sequence[str]] = None,
          shapes: Optional[Sequence[str]] = None, force: bool = False,
          echo=print, layers: Optional[Dict[str, int]] = None,
          trace: bool = False, timeout: float = 900,
          device: Optional[str] = None) -> list:
    """Every cell of ``meshes`` x ``archs`` x ``shapes`` (default: all),
    each arch of ``layers`` also at its cut depth (with ``trace``, each
    traced in a subprocess of ``timeout`` seconds), one at a time, a
    line each through ``echo``, then the summary line; returns the
    cells' records."""
    archs = list(archs or list_archs())
    shapes = list(shapes or SHAPES_BY_NAME)
    cuts = {canonical(a): n for a, n in (layers or {}).items()}
    results = []
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                t0 = time.time()
                res = run_one(arch, shape, mesh, force,
                              cuts.get(canonical(arch)), trace, timeout,
                              device)
                echo(line(res, mesh, time.time() - t0 if trace else None))
                results.append(res)
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skip" for r in results)
    n_bad = len(results) - n_ok - n_skip
    echo(f"\nSWEEP DONE: {n_ok} ok, {n_skip} skip, {n_bad} failed / "
         f"{len(results)} cells")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single",
                    help="single, multi, both, or DxM / PxDxM")
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="*", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--layers", nargs="*", default=[], metavar="ARCH=L",
                    help="also report these archs at L layers")
    ap.add_argument("--trace", action="store_true",
                    help="also trace each cell's rank 0 (a subprocess a "
                         "cell)")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds a traced cell may take")
    ap.add_argument("--device", default=None,
                    help="the traced tensors' device type (default: the "
                         "card's; cpu on a host without one)")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for m in meshes:
        mesh_shape(m)
    cuts = {a: int(n) for a, n in (x.split("=") for x in args.layers)}
    res = sweep(meshes, args.archs, args.shapes, args.force,
                echo=lambda s: print(s, flush=True), layers=cuts,
                trace=args.trace, timeout=args.timeout, device=args.device)
    return 0 if all(r.get("status") in ("ok", "skip", "timeout")
                    for r in res) else 1


if __name__ == "__main__":
    sys.exit(main())
