"""The readers of the program's spans (``perfbench/core/spans.py`` and the
``program_span`` metrics it serves) on a synthetic recorder, on an empty
one, on a program without the recorder, and on the real recorder over a
CPU run of the fleet stream cell.

``BENCHMARK.json`` does not list these metrics yet: the tests append the
entries below to it, as the change that lists them would."""
import sys
from types import SimpleNamespace

import pytest

from perfbench.conftest import TINY_SEED
from perfbench.core import bench

# what the synthetic recorder's spans give, metric by metric
EXPECTED = {
    # windows 1-3 own 100 - 80, 110 - 85 - 4 and 130 - (50 + 40) ms
    "window_host_ms": 21.0,
    "graph_launch_ms": 12.0,
    "harvest_wait_ms": 85.0,
    "ckpt_wait_ms": 4.0 / 3,
    "ckpt_write_ms": 30.0,
    "stage_synth_ms": 4.15,
    "stage_roidet_ms": 1.25,
    "stage_control_ms": 0.35,
    "stage_encode_ms": 6.5,
    "stage_finish_ms": 2.05,
}
SPAN_METRICS = tuple(EXPECTED)
# the three that time the host around the graph launches are read in the
# profiled windows, where CUPTI slows the launches: their readers say so
PROFILED = ("window_host_ms", "graph_launch_ms", "harvest_wait_ms")
# the layers as the accepted metrics name them, letter for letter
LAYERS = {
    "window_host_ms": "fleet stream (serve/stream.py)",
    "graph_launch_ms": "episode and CUDA graphs (core/scheduler.py, "
                       "core/fleet.py)",
    "harvest_wait_ms": "episode and CUDA graphs (core/scheduler.py, "
                       "core/fleet.py)",
    "ckpt_wait_ms": "checkpoint (ckpt/checkpoint.py)",
    "ckpt_write_ms": "checkpoint (ckpt/checkpoint.py)",
}
MOVES = {"window_host_ms": "window_p95_ms", "ckpt_wait_ms": "window_p95_ms",
         "ckpt_write_ms": "window_p95_ms"}


def span_entries():
    """The ``per_layer`` entries of the ten metrics."""
    return [{"name": name, "unit": "ms", "better": "lower",
             "source": "program_span",
             "layer": LAYERS.get(name, "slot stages inside the episode "
                                       "graphs (core/fleet.py)"),
             "moves": MOVES.get(name, "camera_slots_per_s"),
             "workloads": ["ds16.stream"]} for name in SPAN_METRICS]


def with_span_metrics(b):
    """BENCHMARK.json with the ten entries appended to ``per_layer``."""
    b = dict(b, per_layer=list(b["per_layer"]) + span_entries())
    return b


class SyntheticRecorder:
    """A recorder of fixed spans: ``spans()`` as the program's gives them
    (name, t0, t1 in seconds, window)."""

    def __init__(self, spans=()):
        self._spans = list(spans)

    def spans(self):
        return list(self._spans)


def _sp(name, ms, window=None, t0=0.0):
    return SimpleNamespace(name=name, t0=t0, t1=t0 + ms * 1e-3,
                           window=window)


def synthetic_recorder() -> SyntheticRecorder:
    """Three traced windows, their checkpoint writes and four slots'
    device stages, plus spans that belong to no traced window."""
    spans = []
    for w, (whole, launch) in enumerate(((100, 12), (110, 15), (130, 11)),
                                        start=1):
        spans += [_sp("stream.window", whole, w, t0=float(w)),
                  _sp("episode.launch", launch, w)]
    spans += [_sp("harvest.wait", 80, 1), _sp("harvest.wait", 85, 2),
              _sp("harvest.wait", 50, 3), _sp("harvest.wait", 40, 3),
              _sp("ckpt.wait", 4, 2),
              _sp("ckpt.write", 30, 1), _sp("ckpt.write", 24, 2),
              _sp("ckpt.write", 40, 3),
              # outside the traced windows: no stream.window of its own
              _sp("harvest.wait", 500, 9), _sp("ckpt.wait", 500, None),
              _sp("stream.offer", 1, 4)]
    stages = {"synth": (4.0, 4.2, 4.1, 4.3), "roidet": (1.2, 1.3, 1.2, 1.3),
              "control": (0.3, 0.4, 0.3, 0.4), "encode": (6.0, 7.0, 6.5, 6.5),
              "finish": (2.0, 2.1, 2.0, 2.1)}
    for st, ms in stages.items():
        spans += [_sp(f"stage.{st}", v, 1 + i // 2)
                  for i, v in enumerate(ms)]
    return SyntheticRecorder(spans)


@pytest.fixture
def cell():
    return bench.find_cell(with_span_metrics(bench.load_benchmark()),
                           "ds16.stream")


def _read(name, rd):
    return bench.metric_reader(name).read(rd)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_arithmetic_on_a_synthetic_recorder(cell, name):
    rd = bench.Readings(cell, counters={
        "span_recorder": synthetic_recorder()})
    assert _read(name, rd) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_finds_nothing_in_an_empty_recorder(cell, name):
    rd = bench.Readings(cell, counters={"span_recorder":
                                        SyntheticRecorder()})
    assert _read(name, rd) is None


def test_span_metrics_are_program_spans_of_the_cell(cell):
    """Appended as new entries, the ten resolve for the cell after its
    accepted metrics, each with its reader file and a known layer and
    end-to-end metric."""
    accepted = bench.find_cell(bench.load_benchmark(), "ds16.stream")
    assert [m["name"] for m in cell.per_layer] == \
        [m["name"] for m in accepted.per_layer] + list(SPAN_METRICS)
    known = {m["name"] for m in accepted.end_to_end}
    layers = {m["layer"] for m in accepted.per_layer}
    entries = {m["name"]: m for m in cell.per_layer}
    for name in SPAN_METRICS:
        m = entries[name]
        assert (bench.BENCH_DIR / "metrics" / f"{name}.py").exists()
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == ["ds16.stream"] and m["moves"] in known
        assert m["layer"] in layers or name.startswith("stage_")
        doc = bench.metric_reader(name).__doc__
        assert ("profiled window" in doc) == (name in PROFILED)


def test_readers_find_nothing_without_the_recorder(cell, monkeypatch):
    """A program from before the recorder (the module cannot be
    imported): every reader returns None and none raises."""
    import repro_torch.common
    monkeypatch.delattr(repro_torch.common, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.common.trace", None)
    rd = bench.Readings(cell)
    got = bench.read_metrics([m for m in cell.per_layer
                              if m["name"] in SPAN_METRICS], rd)
    assert got == {}


def test_readers_on_the_programs_recorder_over_a_cpu_run(tiny_cell):
    """The tiny cell on the CPU with the recorder on: every host span
    metric is found and agrees with the driver's own host clock; the
    stage marks exist only on the card."""
    from repro_torch.common import trace
    trace.clear()
    trace.enable()
    try:
        out = bench.driver_of(tiny_cell).run(tiny_cell, TINY_SEED, 0.0,
                                             True, "cpu", 0.0,
                                             max_windows=2)
    finally:
        trace.enable(False)
    try:
        got = {k: v["value"] for k, v in bench.read_metrics(
            span_entries(), out.readings).items()}
        for name in ("window_host_ms", "graph_launch_ms", "harvest_wait_ms",
                     "ckpt_wait_ms", "ckpt_write_ms"):
            assert got[name] >= 0.0, name
        assert not {f"stage_{s}_ms" for s in ("synth", "roidet", "control",
                                              "encode", "finish")} & set(got)
        walls = sorted(out.readings.durations("serve_window"))
        # a window's own host work and its launch lie inside the window
        assert got["graph_launch_ms"] <= got["window_host_ms"] \
            <= 1e3 * walls[-1] * 1.5
        n_win = sum(sp.name == "stream.window" for sp in trace.spans())
        # the warm-up, one measured (a window of 0 s) and one traced
        assert n_win == 3
    finally:
        trace.clear()
