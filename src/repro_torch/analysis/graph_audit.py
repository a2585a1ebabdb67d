"""Episode-graph invariant audit: the counterpart of
``repro.analysis.jaxpr_audit`` for the port's CUDA graphs.

Checks (see the package docstring for the catalog):

* matrix-count: the registry enumerates exactly ``len(METHODS) x
  len(fleet.EPISODE_BUCKETS)`` episode programs, each naming the four
  graphs of the pipelined body (``full0/1``, ``drain0/1``);
* two-harvest: each episode returns exactly two slot-stacked outputs, the
  (T, 2, C) log pack and the (T, 4) control pack (``_EpisodeGraph.run``'s
  ``packs`` and ``cpacks``), read from a run of ``fleet._episode_eager``
  at T = 2: the "two harvest fetches per run" contract;
* fleet-size-independent keys: ``fleet.slot_camera_keys`` runs the same
  multiset of aten ops at C = 5 and C = 9 (recorded under a
  ``TorchDispatchMode``), and it holds the three threefry blocks of its
  three fold-ins (60 rotations);
* no host read: every registered program runs under ``NoHostReads``,
  which raises on any call that reads a device tensor on the host or
  uploads host data (what would make the card wait, or break a capture).

JAX's donation check has no counterpart: the graphs read and write static
buffers, and no argument is donated.  Neither do ``cost_analysis()`` and
``memory_analysis()``: the port compiles no XLA program.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.graph_audit \
        [--cameras C] [--device cpu]

prints one PASS/FAIL line per check and exits non-zero on any failure.
It runs each program once, eagerly (an episode for 2 slots), on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import sys
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.programs import METHODS, Program, get_programs

# three fold-ins (salt, slot, camera), each one threefry2x32 block of 20
# rotations: (x << r) | (x >> (32 - r))
FOLDS = 3
ROTATIONS = 20
ROTATION_OPS = ("aten.__lshift__.Scalar", "aten.__rshift__.Scalar",
                "aten.bitwise_or.Tensor")
HARVEST_T = 2


class HostRead(AssertionError):
    pass


class NoHostReads(TorchFunctionMode):
    """Raises on every call that reads a device tensor from the host or
    sends host data up inside the region: what would make the card wait
    (``set_sync_debug_mode("error")``) or break a graph capture.  Inside
    ``opaque`` (a kernel's plain version, which on the card is one launch)
    nothing is checked."""

    READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.tolist,
             torch.Tensor.numpy, torch.Tensor.cpu, torch.Tensor.__int__,
             torch.Tensor.__float__, torch.Tensor.__index__, torch.equal,
             torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
             torch.unique, torch.Tensor.unique}

    def __init__(self):
        super().__init__()
        self.depth = 0

    def opaque(self, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            self.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self.depth -= 1
        return run

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth == 0:
            self._check(func, args)
        return func(*args, **kwargs)

    def _check(self, func, args) -> None:
        if func in self.READS:
            raise HostRead(f"host read: {func.__name__}")
        if func in (torch.tensor, torch.as_tensor) and not \
                torch.is_tensor(args[0]):
            raise HostRead(f"upload: {func.__name__} of host data")
        if func is torch.where and len(args) == 1:
            raise HostRead("torch.where(cond) reads the device")
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(torch.is_tensor(i) and i.dtype == torch.bool
                   and i.dim() > 0 for i in idx):
                raise HostRead("boolean-mask indexing reads the device")


def kernel_calls() -> List[Tuple[object, str]]:
    """(module, name) of each kernel's launch (the card's route) and plain
    version (the CPU's): either is one launch on the card that reads its
    operands where they lie, so ``NoHostReads`` treats it as opaque."""
    from repro_torch.kernels.cc_label import ops as cc_ops
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.tx_codec import ops as tx_ops
    return [(cc_ops.ref, "cc_label_ref"), (tx_ops.ref, "tx_codec_ref"),
            (em_ops.ref, "segment_motion_ref"),
            (dp_ops.ref, "knapsack_dp_ref"), (dp_ops.ref, "backtrack_device"),
            (cc_ops, "cc_label_cuda"), (tx_ops, "tx_codec_cuda"),
            (em_ops, "_launch"), (dp_ops, "knapsack_dp_cuda"),
            (dp_ops, "knapsack_dp_solve_cuda")]


@contextlib.contextmanager
def guarded() -> Iterator[NoHostReads]:
    """A ``NoHostReads`` region with every kernel's launch and plain version
    opaque (each restored on exit)."""
    mode = NoHostReads()
    saved = [(mod, name, getattr(mod, name)) for mod, name in kernel_calls()]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, mode.opaque(fn))
        with mode:
            yield mode
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def key_op_multiset(num_cams: int, device=None) -> collections.Counter:
    """The aten ops ``fleet.slot_camera_keys`` runs for one slot of a
    ``num_cams`` fleet (a 0-d slot index, as in the episode), on
    ``device`` (``None``: the card)."""
    from repro_torch.common import prng
    from repro_torch.common.device import resolve_device
    from repro_torch.core import fleet
    device = resolve_device(device)
    key0 = prng.PRNGKey(0, device=device)
    t = torch.zeros((), dtype=torch.int64, device=device)
    cams = torch.arange(num_cams, dtype=torch.int32, device=device)
    with _OpRecorder() as rec:
        fleet.slot_camera_keys(key0, t, cams)
    return rec.ops


def check_key_ops(base: collections.Counter,
                  grown: collections.Counter, what: str) -> Optional[str]:
    """The fleet-size check on two recorded multisets: None if it holds,
    else the failure."""
    if base != grown:
        return (f"prng-fold: slot_camera_keys' aten ops depend on the fleet "
                f"size: {what} {dict(base)} vs {dict(grown)}")
    want = FOLDS * ROTATIONS
    if any(base[op] != want for op in ROTATION_OPS):
        return (f"prng-fold: slot_camera_keys no longer runs {FOLDS} "
                f"threefry fold-ins ({want} rotations): {dict(base)}")
    return None


def stacked_outputs(out, T: int) -> List[Tuple[int, ...]]:
    """Shapes of the outputs of an episode run stacked along its slot
    axis: each is one harvest fetch at the episode's end."""
    from repro_torch.core import fleet
    return [tuple(x.shape) for x in fleet._leaves(out)
            if x.dim() >= 1 and x.shape[0] == T]


def audit(programs: Optional[Sequence[Program]] = None,
          verbose: bool = False, T: int = HARVEST_T,
          device=None) -> List[str]:
    """Run every check on ``device`` (``None``: the card); returns failure
    strings (empty == all invariants hold).  Each program (by default the
    registry built on ``device``) runs once, under ``NoHostReads``."""
    from repro_torch.analysis.programs import Canonical
    from repro_torch.core.fleet import EPISODE_BUCKETS

    failures: List[str] = []
    programs = (get_programs(canon=Canonical(device=device))
                if programs is None else tuple(programs))

    def ok(line: str) -> None:
        if verbose:
            print(f"PASS  {line}")

    episodes = [p for p in programs if p.kind == "episode"]
    want = len(METHODS) * len(EPISODE_BUCKETS)
    if len(episodes) != want:
        failures.append(
            f"matrix-count: {len(episodes)} episode programs registered, "
            f"expected methods x buckets = {want}")
    else:
        ok(f"matrix-count: {want} episode programs ({len(METHODS)} methods "
           f"x {len(EPISODE_BUCKETS)} buckets)")

    for prog in programs:
        try:
            with guarded():
                out = prog.run(T) if prog.kind == "episode" else prog.run()
        except HostRead as e:
            failures.append(f"no-host-read[{prog.name}]: {e}")
            continue
        ok(f"no-host-read[{prog.name}]")
        if prog.kind != "episode":
            continue
        if prog.graphs != ("full0", "full1", "drain0", "drain1"):
            failures.append(f"graphs[{prog.name}]: {prog.graphs}, not the "
                            "pipelined body's four")
        C = prog.statics.num_cams
        stacked = stacked_outputs(out, T)
        if stacked != [(T, 2, C), (T, 4)]:
            failures.append(
                f"two-harvest[{prog.name}]: slot-stacked outputs "
                f"{stacked}, the harvest contract pins exactly 2: "
                f"({T}, 2, {C}) and ({T}, 4)")
        else:
            ok(f"two-harvest[{prog.name}] {stacked}")

    base = key_op_multiset(5, device)
    bad = check_key_ops(base, key_op_multiset(9, device), "C=5 vs C=9")
    if bad:
        failures.append(bad)
    else:
        ok(f"prng-fold: fleet-size-independent, {FOLDS} fold-ins "
           f"({sum(base.values())} aten ops)")
    return failures


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quiet", action="store_true",
                    help="failures only (default prints each PASS)")
    ap.add_argument("--cameras", type=int, default=None,
                    help="fleet size of the canonical scene (default: "
                         "SceneConfig()'s)")
    ap.add_argument("--device", default=None,
                    help="where the programs run (default: the card; "
                         "'cpu' to run without one)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    from repro_torch.analysis.programs import Canonical, canonical_system
    from repro_torch.common.device import resolve_device
    from repro_torch.data.synthetic import SceneConfig
    dev = resolve_device(args.device)
    scfg = SceneConfig(seed=0) if args.cameras is None else SceneConfig(
        seed=0, num_cameras=args.cameras)
    progs = get_programs(canon=Canonical(canonical_system(dev, scfg)))
    failures = audit(progs, verbose=not args.quiet, device=dev)
    for f in failures:
        print(f"FAIL  {f}")
    if failures:
        print(f"graph audit: {len(failures)} invariant(s) violated")
        return 1
    print(f"graph audit: all invariants hold ({len(progs)} programs, each "
          f"run once on {dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
