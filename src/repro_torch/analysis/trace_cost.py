"""One rank's step traced on fake tensors: the counterpart of a compiled
executable's ``memory_analysis()`` and ``cost_analysis()`` and of the
collectives parsed from its HLO.

``trace(fn, *args)`` runs ``fn`` once on ``args`` (``FakeTensor``s:
shapes, dtypes and devices, nothing allocated) under the args'
``FakeTensorMode`` and a ``TorchDispatchMode`` that sees every aten and
c10d op the step issues, forward and backward, on one rank.  On a fake
process group (``launch.mesh.fake_world``) the collectives issue
nothing, so a rank of a (16, 16) world traces on a host with no card.
It returns:

* ``memory``: JAX's five keys.  Live bytes are counted per storage (a
  view shares its base's), each rounded up to 512 B as the CUDA caching
  allocator rounds, from the op that makes a storage until the storage
  dies (a weak reference to it: a tensor autograd saves for backward
  lives until backward releases it).  ``argument_bytes`` and
  ``output_bytes`` are the unrounded bytes of the storages of the inputs
  and of the outputs; ``alias_bytes`` those of the outputs that are
  inputs' storages (the parameters and moments of a step that updates
  them in place, the cache of a decode: JAX's donation);
  ``peak_estimate_bytes`` is the peak of the live bytes, and
  ``temp_bytes`` the rest of JAX's sum ``argument + output + temp -
  alias = peak``: the peak above the arguments and the outputs that are
  not arguments.
* ``cost``: ``flops`` are the matrix products' (``torch.utils.
  flop_counter``'s formulas for mm, bmm, addmm, baddbmm and the
  convolutions, forward and backward) plus the hand-written kernels'
  stand-ins' own counts; elementwise ops are not counted, which XLA's
  ``cost_analysis`` counts.  ``bytes accessed`` is every aten op's input
  and output bytes (views and allocations move none), op by op: no
  fusion, so it bounds XLA's fused figure from above.
  ``transcendentals`` are the elements of exp, log, tanh, erf, rsqrt,
  sigmoid and silu outputs.
* ``collectives``: ``roofline.analysis.parse_collectives`` of the c10d
  ops (kind, result bytes, group size);
* ``launches``: the stand-ins the trace reached, by kernel name (one a
  launch the kernel would make);
* ``donated``: the indices of the flattened ``args`` leaves the step
  wrote in place (their version counters moved);
* ``trace_s``: the trace's wall seconds.

A kernel's dispatcher takes its stand-in only on fake tensors
(``common.device.is_fake``); the stand-in returns the kernel's outputs
at their shapes and dtypes, allocates its workspace and calls
``common.device.record_kernel`` with the FLOPs and bytes of the same
formulas as PERF.md's bound column, which ``trace`` counts through the
hook it installs there (``KERNEL_RECORDER``).

The trace disables Python's cyclic garbage collector and collects its
youngest generation after each op: the fake mode's own reference cycles
(pytree's and its dispatch's recursive closures) hold the op's tensors,
which a run on the card frees at once; left to the collector's timing,
the peak of the same step moved by 18% from one trace to the next.
"""
from __future__ import annotations

import gc
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.common import device as _device
from repro_torch.roofline.analysis import parse_collectives

ALIGN = 512           # the CUDA caching allocator's rounding

_aten = torch.ops.aten
FLOP_OPS = {_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm,
            _aten.convolution, _aten._convolution,
            _aten.convolution_backward}
TRANSCENDENTAL = {"exp", "exp_", "log", "log_", "tanh", "tanh_", "erf",
                  "erf_", "rsqrt", "rsqrt_", "sigmoid", "sigmoid_",
                  "silu", "silu_"}
# ops that make a tensor without reading or writing its bytes
NO_BYTES = {"empty", "empty_like", "empty_strided", "lift_fresh",
            "lift_fresh_copy", "_local_scalar_dense"}
COLLECTIVES = {"allreduce_": "all-reduce", "allgather_": "all-gather",
               "_allgather_base_": "all-gather",
               "allgather_into_tensor_coalesced_": "all-gather",
               "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter",
               "reduce_scatter_tensor_coalesced_": "reduce-scatter",
               "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
               "send": "collective-permute"}
# which argument holds a collective's result: the tensors it reduces in
# place (0) or its outputs (0 as well: c10d's signatures put them first)
_OUT_ARG = 0
# c10d ops that move nothing a rank must wait for on the trace's path
_NO_TRAFFIC = {"recv_", "recv_any_source_", "barrier", "monitored_barrier_"}

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN if n else 0


def _tensors(x: Any, out: Optional[List[torch.Tensor]] = None
             ) -> List[torch.Tensor]:
    """The tensors of a nest of lists, tuples and dicts (sorted keys, as
    ``jax.tree.leaves`` orders them), depth first."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _tensors(x[k], out)
    return out


def _op_kind(func) -> Tuple[str, bool, bool, bool, bool]:
    """(name, c10d, moves bytes, a product, transcendental) of an op."""
    name = func._overloadpacket.__name__
    c10d = func.namespace == "c10d"
    return (name, c10d,
            not (c10d or func.is_view or name in NO_BYTES),
            func._overloadpacket in FLOP_OPS, name in TRANSCENDENTAL)


class _Recorder(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.live: Dict[int, Tuple[int, weakref.ref]] = {}
        self.cur = 0
        self.peak = 0
        self.flops = 0.0
        self.kernel_flops = 0.0
        self.nbytes = 0.0
        self.transcendentals = 0
        self.records: List[Tuple[str, int, int]] = []
        self.launches: Dict[str, int] = {}
        self.ops = 0

    def kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One launch of a hand-written kernel (``common.device.
        record_kernel``)."""
        self.launches[name] = self.launches.get(name, 0) + 1
        self.kernel_flops += flops
        self.nbytes += nbytes

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live from now until it dies."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        n = _rounded(st.nbytes())

        def dead(_ref, key=key, n=n) -> None:
            if self.live.pop(key, None) is not None:
                self.cur -= n
        self.live[key] = (n, weakref.ref(st, dead))
        self.cur += n
        self.peak = max(self.peak, self.cur)

    def collective(self, name: str, args) -> None:
        if name in _NO_TRAFFIC:
            return
        kind = COLLECTIVES.get(name)
        if kind is None:
            raise NotImplementedError(f"c10d.{name}: no collective kind")
        group = next(a for a in args if isinstance(a, torch.ScriptObject))
        n = torch.distributed.ProcessGroup.unbox(group).size()
        out = sum(_nbytes(t) for t in _tensors(args[_OUT_ARG]))
        self.records.append((kind, out, n))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        gc.collect(0)            # the fake mode's cycles (module docstring)
        if func.namespace == "prim":
            return out
        kind = _KINDS.get(func)
        if kind is None:
            kind = _KINDS[func] = _op_kind(func)
        name, c10d, moves, product, transc = kind
        self.ops += 1
        outs = _tensors(out)
        if c10d:
            self.collective(name, args)
        elif moves:
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in _tensors((args, kwargs)) + outs)
        if product:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if transc:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self.track(t)
        return out


_KINDS: Dict[Any, Tuple[str, bool, bool, bool, bool]] = {}


def _storages(tensors) -> Dict[int, int]:
    """id of each distinct storage -> its bytes."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out


def trace(fn: Callable, *args, kwargs: Optional[dict] = None
          ) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once on fake tensors and return its
    ``memory``, ``cost``, ``collectives``, ``launches``, ``donated``,
    ``ops`` (aten and c10d ops seen), ``trace_s`` (see the module
    docstring) and ``out``, ``fn``'s fake outputs.  ``args`` are nests of dicts, lists, tuples and
    NamedTuples of ``FakeTensor``s of one ``FakeTensorMode``, and
    anything else (host ints) passed through."""
    from torch._guards import detect_fake_mode
    kwargs = kwargs or {}
    leaves = _tensors((args, kwargs))
    mode = detect_fake_mode(leaves)
    if mode is None:
        raise ValueError("trace needs fake tensors among its arguments")
    versions = [t._version for t in leaves]
    arg_st = _storages(leaves)
    rec = _Recorder()
    # the arguments' storages are live from the start (held by the caller)
    for t in leaves:
        rec.track(t)
    t0 = time.perf_counter()
    outer = _device.KERNEL_RECORDER
    _device.KERNEL_RECORDER = rec.kernel
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with mode, rec:
            out = fn(*args, **kwargs)
    finally:
        _device.KERNEL_RECORDER = outer
        if was:
            gc.enable()
    secs = time.perf_counter() - t0
    outs = _tensors(out)
    out_st = _storages(outs)
    arg_b = sum(arg_st.values())
    out_b = sum(out_st.values())
    alias_b = sum(n for k, n in out_st.items() if k in arg_st)
    peak = rec.peak
    return {
        "memory": {
            "argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": peak - arg_b - out_b + alias_b,
            "alias_bytes": alias_b, "peak_estimate_bytes": peak},
        "cost": {"flops": rec.flops + rec.kernel_flops,
                 "bytes accessed": rec.nbytes,
                 "transcendentals": float(rec.transcendentals),
                 "product_flops": rec.flops,
                 "kernel_flops": rec.kernel_flops},
        "collectives": parse_collectives(rec.records),
        "launches": dict(rec.launches),
        "donated": [i for i, (t, v) in enumerate(zip(leaves, versions))
                    if t._version != v],
        "ops": rec.ops,
        "trace_s": secs,
        "out": out,
    }


def fake_tree(x: Any, mode) -> Any:
    """``x`` (a nest of NamedTuples, tuples, lists and dicts) with every
    tensor replaced by its fake copy in ``mode``; other leaves kept."""
    if isinstance(x, torch.Tensor):
        return mode.from_tensor(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(fake_tree(y, mode) for y in x))
    if isinstance(x, (list, tuple)):
        return type(x)(fake_tree(y, mode) for y in x)
    if isinstance(x, dict):
        return {k: fake_tree(v, mode) for k, v in x.items()}
    return x


def trace_real(fn: Callable, *args) -> Dict[str, Any]:
    """``trace`` of ``fn`` on fake copies of ``args`` (real or meta
    tensors), which stay as they were."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    return trace(fn, *fake_tree(args, mode))
