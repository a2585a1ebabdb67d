"""The harness's core: find a cell's files by name, hold what a run
records, and print the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``
through the ``file`` of its ``configs`` entry), a traffic mix
(``traffic/<name>.json``, whose ``driver`` names ``drivers/<driver>.py``)
and, through the metric lists, the readers ``metrics/<name>.py``.  Adding a
configuration, a traffic mix, a driver or a metric is adding files and
entries: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]     # the checkout
BENCH_DIR = Path(__file__).resolve().parents[1]
BENCHMARK_JSON = ROOT / "BENCHMARK.json"

# top-level module names that no process of the benchmark may hold: the
# JAX stack and the JAX package the port was made from.  Names compare
# whole, up to the first dot ("repro_torch" is the port, not "repro").
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    mods = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(mods)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def process_start_offset() -> float:
    """Seconds from this process's start to now (from /proc; 0 where it
    cannot be read)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        fields = stat.rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_benchmark(path: Path = BENCHMARK_JSON) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with its files and metric entries."""
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or cell in cells


def find_cell(bench: Dict[str, Any], name: str,
              root: Path = ROOT) -> Cell:
    """The cell called ``name`` with its configuration and traffic files
    read, and the metric entries that apply to it; ``root`` is the
    checkout that holds the benchmark's folder."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    bench_dir = Path(root) / BENCH_DIR.name
    traffic = json.loads((bench_dir / "traffic"
                          / f"{entry['traffic']}.json").read_text())
    return Cell(name=name, entry=entry, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                bench_dir=bench_dir)


def driver_of(cell: Cell) -> ModuleType:
    """The driver module the cell's traffic names (``drivers/<name>.py``)."""
    name = cell.traffic["driver"]
    return load_module(cell.bench_dir / "drivers" / f"{name}.py",
                       f"perfbench_driver_{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader of metric ``name`` (``metrics/<name>.py``)."""
    return load_module(Path(bench_dir) / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_"))


@dataclass
class DeviceTrace:
    """What the profiler recorded over the traced span."""
    window_s: float                      # the span's length (host clock)
    busy_s: float                        # union of device activity in it
    kernels: List[Tuple[str, float]]     # (name, seconds) per kernel run
    other_ops: List[Tuple[str, float]]   # copies and sets on the device
    idle_gaps: List[Tuple[str, float]]   # (host activity, seconds)

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        ops: Dict[str, float] = {}
        for name, s in self.kernels + self.other_ops:
            ops[name] = ops.get(name, 0.0) + s
        gaps: Dict[str, float] = {}
        for name, s in self.idle_gaps:
            gaps[name] = gaps.get(name, 0.0) + s
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:200], v] for k, v in order(ops)],
                "idle_gaps": [[k[:200], v] for k, v in order(gaps)]}


@dataclass
class Readings:
    """What one run recorded: host-clock spans by name, counters, and the
    device trace of a traced run."""
    cell: Cell
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    counters: Dict[str, Any] = field(default_factory=dict)
    device: Optional[DeviceTrace] = None
    # the reference's logs that the correctness check compared: {log key:
    # values over the compared slots}
    reference: Optional[Dict[str, Any]] = None
    # lines for the run's standard error (before the check's lines)
    notes: List[str] = field(default_factory=list)

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans.setdefault(name, []).append((t0, t1))

    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for t0, t1 in self.spans.get(name, [])]

    def total(self, name: str) -> Optional[float]:
        d = self.durations(name)
        return sum(d) if d else None


@dataclass
class Check:
    """One number the correctness check compares, with its limit."""
    name: str
    value: float
    limit: Optional[float]
    at_most: bool = True        # value <= limit (else value >= limit)

    @property
    def ok(self) -> bool:
        if self.limit is None or not math.isfinite(self.value):
            return False
        return (self.value <= self.limit if self.at_most
                else self.value >= self.limit)

    def line(self) -> str:
        op = "<=" if self.at_most else ">="
        return (f"check {self.name} {self.value!r} {op} {self.limit!r} "
                f"{'ok' if self.ok else 'FAILED'}")


@dataclass
class Outcome:
    """A driver's answer: the run's readings and its correctness."""
    readings: Readings
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    device_kind: str
    device_count: int


def read_metrics(entries: List[Dict[str, Any]], readings: Readings
                 ) -> Dict[str, Dict[str, Any]]:
    """Each metric whose reader finds something, by name: value and
    unit."""
    out = {}
    for m in entries:
        value = metric_reader(m["name"],
                              readings.cell.bench_dir).read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(outcome: Outcome, metrics: Dict[str, Any], trace: bool
                ) -> Dict[str, Any]:
    device: Dict[str, Any] = {"platform": "gpu", "kind": outcome.device_kind,
                              "count": outcome.device_count,
                              "memory_peak_bytes": outcome.memory_peak_bytes}
    line: Dict[str, Any] = {
        "correct": all(c.ok for c in outcome.checks) and bool(outcome.checks),
        "attempted": outcome.attempted, "failed": outcome.failed,
        "metrics": metrics, "device": device}
    dt = outcome.readings.device
    if trace and dt is not None:
        device["busy_s"] = dt.busy_s
        device["window_s"] = dt.window_s
        line["breakdown"] = dt.breakdown()
    line["check"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in outcome.checks}
    return line
