"""Program manifest: for every audited program, its name, the graphs it
captures and its inputs' shapes and dtypes by name.

The counterpart of ``repro.analysis.manifest``, with no golden file: the
port's tests compare the manifest live with JAX's ``get_programs()``,
name by name and input by input (``diff_against``), and every difference
must be one that ``EXCEPTIONS`` names with its reason.  JAX's
``signature`` hash, ``donated`` leaves, ``cost`` and ``memory`` fields
come from XLA's lowering and compiled executable and have no counterpart.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.manifest [--device cpu]

prints the manifest as JSON (the canonical deployment, built on the card
unless ``--device cpu`` is given; nothing runs but building the inputs).
"""
from __future__ import annotations

import fnmatch
import json
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.analysis.programs import (CTRL_ARGS, CTRL_SCAN_ARGS,
                                           Canonical, Program, get_programs)

Input = Tuple[str, Tuple[int, ...], str]      # (name, shape, dtype)

# JAX's positional arguments of each program kind, by the port's names
# (``repro.analysis.programs.Canonical.*_args``), so that the leaves of
# JAX's arguments and the port's inputs meet under one name
JAX_ARGS: Dict[str, Tuple[str, ...]] = {
    "episode": ("ctx.server", "ctx.light", "ctx.mlp", "ctx.jcab_util",
                "ctx.jcab_res", "ctx.lam", "ctx.scene", "xs.trace",
                "xs.live", "xs.active", "xs.t_idx", "ctx.t_first",
                "xs.t_len", "ctx.key0", "ctx.skey", "ctx.tau_wl",
                "ctx.tau_wh", "carry.est", "carry.ref", "carry.live_prev"),
    "slot_step": ("ctx.server", "frames", "masks", "b", "r", "keys", "keep",
                  "gt_boxes", "gt_valid", "live_t"),
    "ctrl": CTRL_ARGS,
    "ctrl_scan": CTRL_SCAN_ARGS,
}

_SLOT_MADE = ("frames", "masks", "b", "r", "keys", "keep", "gt_boxes",
              "gt_valid")
_ALL = ("episode", "slot_step", "ctrl", "ctrl_scan")

# every way the port's inputs may differ from JAX's: (program kinds,
# input name patterns, difference, reason).  "dtype": same shape, the
# dtype differs; "layout": the port's shape is JAX's with the axes moved
# (HWIO -> OIHW); "jax-only" / "port-only": an input of one side only.
EXCEPTIONS: Tuple[Tuple[Tuple[str, ...], Tuple[str, ...], str, str], ...] = (
    (("episode",), ("ctx.key0", "ctx.skey"), "dtype",
     "run keys are uint32 in JAX and int64 in the port, which holds "
     "uint32 values in int64 (ckpt/checkpoint.py:30)"),
    (("episode",), ("xs.t_idx", "ctx.t_first"), "dtype",
     "slot indices are int32 in JAX and int64 in the port (torch indexes "
     "with int64)"),
    (("episode", "slot_step"), ("ctx.server.c?", "ctx.server.head",
                                "ctx.light.c?", "ctx.light.head"), "layout",
     "convolution kernels are HWIO in JAX and OIHW in the port: the same "
     "numbers, transposed"),
    (("episode",), ("xs.active", "xs.t_len"), "jax-only",
     "JAX runs the padded slots of a bucket and freezes the carry with "
     "these; the port never runs a padded slot"),
    (_ALL, ("ctx.tables.*", "tables.*"), "port-only",
     "the codec's bitrate, resolution and pool-factor tables on the "
     "device, uploaded once a run (JAX folds them into the program)"),
    (("slot_step",), _SLOT_MADE, "jax-only",
     "JAX's unified slot step starts from the synthesized frames and the "
     "control's picks; the port's step makes them on the device from "
     "(t, W_t, live_t)"),
    (("slot_step",), ("ctx.*", "carry.*", "t", "W_t"), "port-only",
     "the port's slot step runs synthesis, ROIDet, control and the keep "
     "decision inside it: it reads the episode's context and carry"),
)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def entry(prog: Program) -> Dict[str, Any]:
    return {"kind": prog.kind, "graphs": list(prog.graphs),
            "inputs": [[n, list(t.shape), _dtype_name(t.dtype)]
                       for n, t in prog.inputs.items()]}


def build_manifest(programs: Optional[Sequence[Program]] = None,
                   device=None) -> Dict[str, Any]:
    """The manifest of ``programs``, by default the registry built on
    ``device`` (``None``: the card)."""
    programs = (get_programs(canon=Canonical(device=device))
                if programs is None else tuple(programs))
    return {"programs": {p.name: entry(p) for p in programs}}


def _exception(kind: str, name: str, what: str) -> Optional[int]:
    """Index of the EXCEPTIONS row that allows ``what`` for ``name``."""
    for i, (kinds, pats, diff, _) in enumerate(EXCEPTIONS):
        if (diff == what and kind in kinds
                and any(fnmatch.fnmatchcase(name, p) for p in pats)):
            return i
    return None


def diff_against(manifest: Dict[str, Any],
                 reference: Dict[str, Tuple[str, Iterable[Input]]]
                 ) -> Tuple[List[str], Set[int]]:
    """Compare the port's manifest with a reference ``{program: (kind,
    [(input, shape, dtype), ...])}`` (JAX's registry, its leaves named
    by ``JAX_ARGS``): (differences that no exception allows, the indices
    of the EXCEPTIONS rows that allowed one)."""
    drift: List[str] = []
    used: Set[int] = set()
    progs = manifest["programs"]
    for name in sorted(set(progs) | set(reference)):
        if name not in progs:
            drift.append(f"{name}: in the reference, not in the port")
            continue
        if name not in reference:
            drift.append(f"{name}: in the port, not in the reference")
            continue
        kind = progs[name]["kind"]
        mine = {n: (tuple(s), d) for n, s, d in progs[name]["inputs"]}
        theirs = {n: (tuple(s), d) for n, s, d in reference[name][1]}

        def allow(inp: str, what: str, text: str) -> None:
            i = _exception(kind, inp, what)
            if i is None:
                drift.append(f"{name}: {inp}: {text}")
            else:
                used.add(i)

        for inp in sorted(set(mine) | set(theirs)):
            if inp not in mine:
                allow(inp, "jax-only", f"JAX's input {theirs[inp]} has no "
                      "counterpart")
            elif inp not in theirs:
                allow(inp, "port-only", f"the port's input {mine[inp]} has "
                      "no counterpart in JAX")
            elif mine[inp] != theirs[inp]:
                (ms, md), (ts, td) = mine[inp], theirs[inp]
                if ms == ts:
                    allow(inp, "dtype", f"dtype {md} vs JAX's {td}")
                elif (md == td and len(ts) == 4
                      and ms == (ts[3], ts[2], ts[0], ts[1])):
                    allow(inp, "layout", f"shape {ms} is JAX's {ts} "
                          "transposed")
                else:
                    drift.append(f"{name}: {inp}: {mine[inp]} vs JAX's "
                                 f"{theirs[inp]}")
    return drift, used


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the registry's inputs are built (default: "
                         "the card; 'cpu' to run without one)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    print(json.dumps(build_manifest(device=args.device), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
