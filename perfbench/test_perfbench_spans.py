"""The readers of the program's spans (``perfbench/core/spans.py`` and the
``program_span`` metrics it serves) on a synthetic recorder, on an empty
one, on a program without the recorder, and on the real recorder over a
CPU run of the fleet stream cell.

``BENCHMARK.json`` lists the ten metrics as ``span_entries()`` gives
them."""
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
# the stage marks are read in the profiled windows, the host spans in the
# windows served before them with no profiler: their readers say so
PROFILED = tuple(n for n in SPAN_METRICS if n.startswith("stage_"))
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
    return bench.find_cell(bench.load_benchmark(), "ds16.stream")


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
    """The benchmark lists the ten for the cell as ``span_entries()``
    gives them, each with its reader file and a known layer and
    end-to-end metric."""
    entries = {m["name"]: m for m in cell.per_layer}
    assert [entries.get(e["name"]) for e in span_entries()] == \
        span_entries()
    known = {m["name"] for m in cell.end_to_end}
    layers = {m["layer"] for m in cell.per_layer
              if m["name"] not in SPAN_METRICS}
    for name in SPAN_METRICS:
        m = entries[name]
        assert (bench.BENCH_DIR / "metrics" / f"{name}.py").exists()
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == ["ds16.stream"] and m["moves"] in known
        assert m["layer"] in layers or name.startswith("stage_")
        doc = bench.metric_reader(name).__doc__
        assert ("profiled window" in doc) == (name in PROFILED)


def test_readers_find_nothing_without_the_recorder(cell, monkeypatch):
    """Readings that carry no recorder (an untraced run's), with the
    program's recorder module unimportable besides: every reader returns
    None and none raises or reads the module."""
    import repro_torch.common
    monkeypatch.delattr(repro_torch.common, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.common.trace", None)
    rd = bench.Readings(cell)
    got = bench.read_metrics([m for m in cell.per_layer
                              if m["name"] in SPAN_METRICS], rd)
    assert got == {}


def test_readers_on_the_programs_recorder_over_a_cpu_run(tiny_cell):
    """The tiny cell on the CPU, traced: the driver turns the recorder on
    for a window with no profiler and the traced window, keeps their
    spans and turns it off again; every host span metric is found in the
    first and agrees with the driver's own host clock; the stage marks
    exist only on the card."""
    from repro_torch.common import trace
    trace.enable(False)
    try:
        out = bench.driver_of(tiny_cell).run(tiny_cell, TINY_SEED, 0.0,
                                             True, "cpu", 0.0,
                                             max_windows=2)
        assert not trace.active()
        rd = out.readings
        got = {k: v["value"] for k, v in bench.read_metrics(
            span_entries(), rd).items()}
        for name in ("window_host_ms", "graph_launch_ms", "harvest_wait_ms",
                     "ckpt_wait_ms", "ckpt_write_ms"):
            assert got[name] >= 0.0, name
        assert not {f"stage_{s}_ms" for s in ("synth", "roidet", "control",
                                              "encode", "finish")} & set(got)
        walls = sorted(rd.durations("serve_window"))
        # a window's own host work and its launch lie inside the window
        assert got["graph_launch_ms"] <= got["window_host_ms"] \
            <= 1e3 * walls[-1] * 1.5
        # the warm-up (1) and the measured window (2, of 0 s) unrecorded,
        # then one window of each part
        assert rd.counters["span_windows"] == {"host": [3], "profiled": [4]}
        kept = rd.counters["span_recorder"].spans()
        assert sorted(sp.window for sp in kept
                      if sp.name == "stream.window") == [3, 4]
        assert out.attempted == 3 and out.failed == 0
    finally:
        trace.clear()


def test_readers_take_their_parts_windows(cell):
    """With the parts named, the host readers read the first part's
    windows and the stage readers the profiled part's."""
    rd = bench.Readings(cell, counters={
        "span_recorder": synthetic_recorder(),
        "span_windows": {"host": [1], "profiled": [2]}})
    assert _read("graph_launch_ms", rd) == pytest.approx(12.0)
    assert _read("harvest_wait_ms", rd) == pytest.approx(80.0)
    assert _read("window_host_ms", rd) == pytest.approx(20.0)
    assert _read("ckpt_wait_ms", rd) == pytest.approx(0.0)
    assert _read("ckpt_write_ms", rd) == pytest.approx(30.0)
    # window 2 holds slots 2 and 3 of each stage
    assert _read("stage_synth_ms", rd) == pytest.approx(4.2)
    assert _read("stage_encode_ms", rd) == pytest.approx(6.5)
    rd.counters["span_windows"] = {"host": [], "profiled": []}
    assert all(_read(n, rd) is None for n in SPAN_METRICS)
