"""The registry of the port's audited programs: every episode graph and
control program, with its inputs as tensors on the meta device.

The counterpart of ``repro.analysis.programs``.  One canonical deployment
(``Canonical``: the scenario harness's ``SceneConfig(seed=0)`` fleet,
``EVAL_FRAMES = 3``, the pinned ``W_CAP_KBPS`` DP capacity) builds every
entry, the same deployment as the JAX registry.  The episode entries come
from ``fleet.episode_inputs`` on the system's own ``_episode_kwargs``, so
an entry's statics and input shapes are those of the CUDA graphs that
``fleet_episode`` captures for it (``fleet._GRAPHS``' key).  A
``Canonical`` built on a system with a camera mesh
(``DeepStreamSystem.mesh``) names the sharded graphs the same way: their
statics carry ``c_pad`` and the mesh's (world size, rank), their inputs
the rank's rows.

The registry enumerates:

* ``episode/<method>/b<bucket>`` — ``len(METHODS) x
  len(fleet.EPISODE_BUCKETS)`` entries, each naming the graphs its
  ``_EpisodeGraph`` captures: ``full0``, ``full1``, ``drain0`` and
  ``drain1`` for the pipelined body, ``step`` for the reference body;
* ``slot_step/unified`` — one slot of the production step,
  ``fleet.slot_front`` followed by ``fleet._finish`` (``_slot_finish``),
  for deepstream (every stage: ROIDet, the utility MLP, the DP);
* ``ctrl/<method>`` / ``ctrl_scan/<method>`` — ``fleet.fleet_control_step``
  and ``fleet.fleet_control_scan`` at the canonical shapes.

Each ``Program`` carries ``inputs`` (name -> meta tensor, in the order of
``fleet._leaves``, the order of a graph key's shapes) and ``run``, which
runs it once eagerly on the concrete inputs it was built from (an
episode for its first ``T`` slots): what ``graph_audit`` holds under
``NoHostReads``.  Building the registry runs nothing but the inputs'
construction (scene, weights, tables) on the canonical device: the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

METHODS: Tuple[str, ...] = ("deepstream", "jcab", "reducto", "static")

# the scenario harness's pinned DP capacity (tests/harness.py W_CAP_KBPS)
W_CAP_KBPS = 8000.0

# harness systems score 3 frames per segment (tests/harness.py build_system)
EVAL_FRAMES = 3

CTRL_SCAN_T = 8          # trace length for the scanned control program

# the seed of the canonical system's weights (init_detector, utility MLP)
WEIGHTS_SEED = 0


# slots of an episode's eager body that ``Program.call`` runs (graph_audit's
# harvest run and the manifest's trace)
CALL_SLOTS = 2


@dataclasses.dataclass(frozen=True)
class Program:
    """One audited program: its inputs by name (meta tensors), the CUDA
    graphs an episode captures, the statics of its graph key, ``run``,
    one eager run on the concrete inputs, and ``call``: (its eager body,
    the concrete inputs as positional arguments, their names' prefixes)
    for ``analysis.trace_cost`` to run on fake copies (an episode for
    ``CALL_SLOTS`` slots)."""
    name: str
    kind: str                      # "episode" | "slot_step" | "ctrl" | "ctrl_scan"
    inputs: Dict[str, torch.Tensor]
    run: Callable[..., Any]
    graphs: Tuple[str, ...] = ()
    statics: Any = None
    call: Optional[Tuple[Callable, Tuple[Any, ...], Tuple[str, ...]]] = None


def named_leaves(prefix: str, x) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of a nest of NamedTuples, tuples, dicts and None, in
    ``fleet._leaves`` order: dict keys sorted, NamedTuple fields in order
    (``ctx.scene.backgrounds``, ``carry.est.a_ema``, ``ctx.server.c1``)."""
    if torch.is_tensor(x):
        return [(prefix, x)]
    if x is None:
        return []
    if isinstance(x, dict):
        items = sorted(x.items())
    elif hasattr(x, "_fields"):
        items = zip(x._fields, x)
    else:
        items = enumerate(x)
    return [leaf for k, v in items
            for leaf in named_leaves(f"{prefix}.{k}" if prefix else str(k),
                                     v)]


def _named_args(names: Sequence[str], args: Sequence[Any]
                ) -> List[Tuple[str, torch.Tensor]]:
    """``named_leaves`` of positional arguments, in argument order."""
    return [leaf for n, a in zip(names, args) for leaf in named_leaves(n, a)]


def meta_inputs(named: Sequence[Tuple[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    return {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
            for n, t in named}


def canonical_system(device=None, scfg=None):
    """The harness's system (``tests/harness.py::build_system``): the
    canonical scene, eval_frames 3, the pinned capacity, an untrained
    utility MLP and the linspace jcab table, with seeded detectors, on
    ``device`` (``None``: the card)."""
    from repro_torch.common import prng
    from repro_torch.common.device import resolve_device
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.core.utility import init_utility_mlp
    from repro_torch.data.synthetic import SceneConfig
    from repro_torch.models.detector import init_detector
    cfg = SystemConfig(scene=scfg if scfg is not None else SceneConfig(seed=0),
                       eval_frames=EVAL_FRAMES, w_cap_kbps=W_CAP_KBPS)
    device = resolve_device(device)
    key = prng.PRNGKey(WEIGHTS_SEED, device=device)
    light_key, server_key, mlp_key = prng.split(key, 3)
    s = DeepStreamSystem(cfg, init_detector(light_key, "light"),
                         init_detector(server_key, "server"), device=device)
    s.mlp = init_utility_mlp(mlp_key)
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    return s


class Canonical:
    """The one deployment every program is built at: a port
    ``DeepStreamSystem`` (by default ``canonical_system(device)``) and a
    bandwidth trace for each bucket (a constant 1000 Kbps, or the slots
    of ``trace`` repeated)."""

    def __init__(self, system=None, trace: Optional[np.ndarray] = None,
                 device=None) -> None:
        self.system = system if system is not None else canonical_system(
            device)
        self.device = self.system.device
        self.cfg = self.system.cfg
        self.C = self.cfg.scene.num_cameras
        self.trace = (np.full(CTRL_SCAN_T, 1000.0) if trace is None
                      else np.asarray(trace, float))

    def trace_of(self, T: int) -> np.ndarray:
        return np.resize(self.trace, T)

    def episode(self, method: str, bucket: int):
        """``fleet.EpisodeInputs`` of a run of ``bucket`` slots."""
        from repro_torch.core import fleet
        from repro_torch.data.synthetic import DeviceScene
        scene = DeviceScene(self.cfg.scene, device=self.device,
                            mesh=self.system.mesh)
        kw = self.system._episode_kwargs(scene, self.trace_of(bucket),
                                         method)
        return fleet.episode_inputs(method, **kw)

    def control(self, method: str, T: Optional[int]):
        """(positional inputs, keyword statics) of ``fleet_control_step``
        (``T`` None) or ``fleet_control_scan`` over ``T`` slots, in JAX's
        argument order."""
        s = self.system
        trace = self.trace_of(T or 1)
        deep = method == "deepstream"
        ctx = s._control_context(method, trace, deep)
        inp = self.episode(method, 8)
        C, dev = self.C, self.device
        f32 = torch.float32
        if T is None:
            ac = (torch.full((C,), 0.5, dtype=f32, device=dev)
                  if deep else None)
            args = (s.mlp if deep else None, inp.ctx.jcab_util,
                    inp.ctx.jcab_res, ctx["lam"], ac, ac, ctx["trace"][0],
                    ctx["est"], ctx["tau_wl"], ctx["tau_wh"],
                    torch.ones((C,), dtype=torch.bool, device=dev),
                    torch.zeros((), dtype=torch.bool, device=dev))
        else:
            ac = torch.full((T, C), 0.5, dtype=f32, device=dev)
            args = (s.mlp if deep else None, inp.ctx.jcab_util,
                    inp.ctx.jcab_res, ctx["lam"], ac, ac, ctx["trace"],
                    ctx["est"], ctx["tau_wl"], ctx["tau_wh"],
                    torch.ones((T, C), dtype=torch.bool, device=dev),
                    torch.zeros((T,), dtype=torch.bool, device=dev))
        cfgc = self.cfg.codec
        statics = dict(
            method=method, ecfg=self.cfg.elastic,
            bitrates=tuple(int(b) for b in cfgc.bitrates_kbps),
            resolutions=tuple(float(r) for r in cfgc.resolutions),
            slot_seconds=float(cfgc.slot_seconds), use_elastic=deep,
            w_cap=int(ctx["w_cap"]), num_cams=C, tables=inp.ctx.tables)
        return args, statics


# the JAX argument names of the control programs (``Canonical.ctrl_args``)
CTRL_ARGS = ("mlp", "jcab_util", "jcab_res", "lam", "a", "c", "W_t", "est",
             "tau_wl", "tau_wh", "live", "reconnect")
CTRL_SCAN_ARGS = ("mlp", "jcab_util", "jcab_res", "lam", "a_trace",
                  "c_trace", "W_trace", "est", "tau_wl", "tau_wh",
                  "live_trace", "reconnect_trace")


def graph_names(pipelined: bool) -> Tuple[str, ...]:
    """The graphs an ``_EpisodeGraph`` captures (``_bodies``' keys)."""
    if not pipelined:
        return ("step",)
    return ("full0", "full1", "drain0", "drain1")


def _episode_program(canon: Canonical, method: str, bucket: int) -> Program:
    from repro_torch.core import fleet
    inp = canon.episode(method, bucket)

    def body(ctx, xs, carry, T: int = CALL_SLOTS):
        return fleet._episode_eager(inp.statics, ctx, xs, carry, T)
    return Program(
        name=f"episode/{method}/b{bucket}", kind="episode",
        inputs=meta_inputs(named_leaves("ctx", inp.ctx)
                           + named_leaves("xs", inp.xs)
                           + named_leaves("carry", inp.carry)),
        run=lambda T=CALL_SLOTS: body(inp.ctx, inp.xs, inp.carry, T),
        graphs=graph_names(inp.statics.pipelined), statics=inp.statics,
        call=(body, (inp.ctx, inp.xs, inp.carry), ("ctx", "xs", "carry")))


def _slot_step_program(canon: Canonical) -> Program:
    from repro_torch.core import fleet
    inp = canon.episode("deepstream", fleet.bucket_len(1))
    s, ctx, xs, carry = inp.statics, inp.ctx, inp.xs, inp.carry
    slot = (xs.t_idx[0], xs.trace[0], xs.live[0])

    def body(ctx, carry, *slot):
        _, st, cpack, inv = fleet.slot_front(s, ctx, carry, *slot)
        return fleet._finish(s, ctx, st, inv), cpack
    names = ("ctx", "carry", "t", "W_t", "live_t")
    named = _named_args(names, (ctx, carry) + slot)
    return Program(name="slot_step/unified", kind="slot_step",
                   inputs=meta_inputs(named),
                   run=lambda: body(ctx, carry, *slot), statics=s,
                   call=(body, (ctx, carry) + slot, names))


def _control_program(canon: Canonical, method: str, scan: bool) -> Program:
    from repro_torch.core import fleet
    args, statics = canon.control(method, CTRL_SCAN_T if scan else None)
    fn = fleet.fleet_control_scan if scan else fleet.fleet_control_step
    names = CTRL_SCAN_ARGS if scan else CTRL_ARGS
    kind = "ctrl_scan" if scan else "ctrl"
    named = (_named_args(names, args)
             + named_leaves("tables", statics["tables"]))

    def body(*a):
        return fn(*a[:-1], **dict(statics, tables=a[-1]))
    return Program(name=f"{kind}/{method}", kind=kind,
                   inputs=meta_inputs(named),
                   run=lambda: fn(*args, **statics), statics=statics,
                   call=(body, args + (statics["tables"],),
                         names + ("tables",)))


def get_programs(kinds: Optional[Sequence[str]] = None,
                 canon: Optional[Canonical] = None,
                 methods: Sequence[str] = METHODS) -> Tuple[Program, ...]:
    """Build the registry (or the ``kinds`` subset) at ``canon``, by
    default ``Canonical()`` on the card.  ``methods`` extends the episode
    matrix (``deepstream_no_elastic``, which the card's runs also
    capture)."""
    from repro_torch.core import fleet
    canon = canon or Canonical()
    want = set(kinds) if kinds is not None else None

    def take(kind: str) -> bool:
        return want is None or kind in want

    progs: List[Program] = []
    if take("episode"):
        for method in methods:
            for bucket in fleet.EPISODE_BUCKETS:
                progs.append(_episode_program(canon, method, bucket))
    if take("slot_step"):
        progs.append(_slot_step_program(canon))
    for kind, scan in (("ctrl", False), ("ctrl_scan", True)):
        if take(kind):
            progs.extend(_control_program(canon, m, scan) for m in METHODS)
    return tuple(progs)
