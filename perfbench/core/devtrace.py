"""Reading the card's activity from a torch.profiler trace.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activity), exports the Chrome trace to a temporary file, reads it and
deletes it.  The span is the ``perfbench.span`` annotation that
``profiled`` puts around ``fn``; busy time is the union of the kernels,
copies and sets that ran on the card inside it, and each idle gap between
them is named after what the host was doing at its middle (the innermost
benchmark annotation, then the innermost host operation or runtime call on
the same thread).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

from perfbench.core.bench import DeviceTrace

SPAN = "perfbench.span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _timeline(events: List[Tuple[float, float, str]]
              ) -> Tuple[List[float], List[str]]:
    """Nested (start, end, name) events of one thread -> a piecewise
    constant timeline: from ``times[i]`` on, ``names[i]`` is the innermost
    event running ('' where none is)."""
    times: List[float] = []
    names: List[str] = []
    stack: List[Tuple[float, float, str]] = []

    def emit(t: float) -> None:
        times.append(t)
        names.append(stack[-1][2] if stack else "")

    for ev in sorted(events, key=lambda e: (e[0], -e[1])):
        while stack and stack[-1][1] <= ev[0]:
            end = stack.pop()[1]
            emit(end)
        stack.append(ev)
        emit(ev[0])
    while stack:
        end = stack.pop()[1]
        emit(end)
    return times, names


def _at(timeline: Tuple[List[float], List[str]], t: float) -> str:
    times, names = timeline
    i = bisect.bisect_right(times, t) - 1
    return names[i] if i >= 0 else ""


def read_trace(trace: Dict) -> DeviceTrace:
    """A Chrome trace (the profiler's export, times in us) -> the span's
    device activity and idle gaps."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError(f"no {SPAN} annotation in the trace")
    sp = max(spans, key=lambda e: float(e["dur"]))
    s0, s1 = float(sp["ts"]), float(sp["ts"]) + float(sp["dur"])
    tid = sp.get("tid")
    kernels, other, dev_iv = [], [], []
    for e in events:
        cat = e.get("cat", "")
        if cat not in DEVICE_CATS:
            continue
        a, d = float(e["ts"]), float(e.get("dur", 0.0))
        if a + d <= s0 or a >= s1:
            continue
        (kernels if cat == "kernel" else other).append((e["name"], d * 1e-6))
        dev_iv.append((max(a, s0), min(a + d, s1)))
    busy = _union(dev_iv)
    annots = _timeline([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                         e["name"]) for e in events
                        if e.get("cat") == "user_annotation"
                        and e.get("name") != SPAN and e.get("tid") == tid])
    host = _timeline([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"]) for e in events
                      if e.get("cat") in HOST_CATS and e.get("tid") == tid])
    gaps: Dict[str, float] = {}
    edges = [(s0, s0)] + busy + [(s1, s1)]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b > a:
            mid = 0.5 * (a + b)
            what = "/".join(x for x in (_at(annots, mid), _at(host, mid))
                            if x) or "host"
            gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-6
    return DeviceTrace(window_s=(s1 - s0) * 1e-6,
                       busy_s=sum(b - a for a, b in busy) * 1e-6,
                       kernels=kernels, other_ops=other,
                       idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def profiled(torch, fn: Callable[[], None]) -> DeviceTrace:
    """Run ``fn`` under torch.profiler and read the card's activity over
    it.  The trace file lives in the run's temporary directory only while
    it is read."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            fn()
            torch.cuda.synchronize()
        time.sleep(0.05)        # the card's activity records arrive late
    fd, path = tempfile.mkstemp(prefix="perfbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return read_trace(data)

