"""The harness on the CPU: discovery by name, adding a cell's files
without editing any (a server detector of its own included), the result
line's schema, the metric arithmetic on synthetic spans and traces, and
the traffic copies against the port's generators."""
import hashlib
import importlib
import json
import math
import shutil

import numpy as np
import pytest

from perfbench.core import bench, devtrace, kernel_cost, peaks
from perfbench.core.flops import detector_flops, fleet_slot_flops
from perfbench.core.traffic import (FAULT_FAMILIES, TRACE_FAMILIES,
                                    make_faults, make_soak_stream,
                                    make_stream, make_trace)
from perfbench.test_perfbench_spans import EXPECTED, synthetic_recorder

CELLS = ("ds16.stream", "ds5.stream")


def with_ds5(b):
    """BENCHMARK.json with the 5-camera cell added as a later change would
    add it: an entry for its configuration file and one for the cell."""
    b = json.loads(json.dumps(b))
    b["configs"].append({"name": "deepstream_c5", "source": "x",
                         "file": "perfbench/configs/deepstream_c5.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "ds5.stream", "config": "deepstream_c5",
                           "traffic": "stream", "chips": 1, "why": "x"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("ds5.stream")
    return b


def test_benchmark_json_keys_and_files():
    b = bench.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    for group in (b["configs"], b["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names)), names
    cells = {w["name"] for w in b["workloads"]}
    assert "ds16.stream" in cells
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        cfg = bench.ROOT / configs[w["config"]]["file"]
        traffic = bench.BENCH_DIR / "traffic" / f"{w['traffic']}.json"
        assert cfg.exists() and traffic.exists(), w
        driver = json.loads(traffic.read_text())["driver"]
        assert (bench.BENCH_DIR / "drivers" / f"{driver}.py").exists()
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    for m in metrics:
        assert (bench.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_find_cell_by_name(name):
    cell = bench.find_cell(with_ds5(bench.load_benchmark()), name)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["driver"] == "fleet_stream"
    assert bench.driver_of(cell).run
    assert {m["name"] for m in cell.end_to_end} == {
        "camera_slots_per_s", "window_p95_ms", "setup_s"}
    listing = [m for m in with_ds5(bench.load_benchmark())["per_layer"]
               if name in m.get("workloads", [name])]
    assert len(cell.per_layer) == len(listing) > 0
    C = {"ds16.stream": 16, "ds5.stream": 5}[name]
    assert cell.config["scene"]["num_cameras"] == C


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="ds16.stream"):
        bench.find_cell(bench.load_benchmark(), "nope")


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A configuration, a traffic mix, a driver and a metric added as new
    files plus new entries, with no existing file edited."""
    root = tmp_path
    shutil.copytree(bench.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench.load_benchmark()
    cfg = json.loads((bench.ROOT / "perfbench/configs/deepstream_c5.json")
                     .read_text())
    cfg["name"] = "deepstream_c3"
    cfg["scene"]["num_cameras"] = 3
    (root / "perfbench/configs/deepstream_c3.json").write_text(
        json.dumps(cfg))
    (root / "perfbench/traffic/burst.json").write_text(json.dumps(
        {"driver": "echo", "generator": "soak_stream", "day_slots": 10}))
    (root / "perfbench/drivers/echo.py").write_text(
        "def run(*a, **k):\n    return 'echo'\n")
    (root / "perfbench/metrics/echo_count.py").write_text(
        "def read(rd):\n    return rd.counters.get('echo')\n")
    b["configs"].append({"name": "deepstream_c3", "source": "x",
                         "file": "perfbench/configs/deepstream_c3.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "ds3.burst", "config": "deepstream_c3",
                           "traffic": "burst", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "echo_count", "unit": "n",
                           "better": "lower", "source": "program_counter",
                           "layer": "echo", "moves": "setup_s",
                           "workloads": ["ds3.burst"]})
    cell = bench.find_cell(b, "ds3.burst", root=root)
    assert cell.config["scene"]["num_cameras"] == 3
    assert bench.driver_of(cell).run() == "echo"
    assert [m["name"] for m in cell.per_layer] == ["echo_count"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    rd = bench.Readings(cell, counters={"echo": 4})
    rd.span("setup", 1.0, 3.5)
    assert bench.read_metrics(cell.per_layer + cell.end_to_end, rd) == {
        "echo_count": {"value": 4.0, "unit": "n"},
        "setup_s": {"value": 2.5, "unit": "s"}}
    # the existing cell still resolves from the copied folder
    assert bench.find_cell(b, "ds16.stream", root=root).name == "ds16.stream"


def _readings(cell):
    rd = bench.Readings(cell)
    rd.span("setup", 0.0, 12.0)
    rd.span("capture", 9.0, 10.5)
    walls = [0.100, 0.110, 0.120, 0.130, 0.300]
    t = 12.0
    for w in walls:
        rd.span("serve_window", t, t + w)
        t += w + 0.001
    rd.span("window", 12.0, 12.0 + 0.8)
    rd.counters.update(camera_slots=5 * 8 * len(walls), cameras=5,
                       degraded_windows=1, ckpt_snapshot_s=[0.001, 0.003],
                       cudnn_allow_tf32=True, trace_slots=16,
                       kernel_shapes={"tx_codec": (5, 10, 96, 160),
                                      "cc_label": (5, 12, 20),
                                      "threefry_normal": (5, 153600)},
                       span_recorder=synthetic_recorder())
    rd.device = bench.DeviceTrace(
        window_s=0.5, busy_s=0.4,
        kernels=[("tx_codec_kernel", 10e-6), ("tx_codec_kernel", 10e-6),
                 ("cc_label_kernel", 4e-6), ("elementwise", 1e-3),
                 ("void threefry_normal_kernel<true>(...)", 20e-6)],
        other_ops=[("Memcpy DtoH", 2e-6)],
        idle_gaps=[("perfbench.offer+serve/cudaGraphLaunch", 0.07),
                   ("host", 0.03)])
    return rd


def test_metric_arithmetic_on_synthetic_spans():
    cell = bench.find_cell(bench.load_benchmark(), "ds16.stream")
    rd = _readings(cell)
    got = bench.read_metrics(cell.end_to_end + cell.per_layer, rd)
    v = {k: x["value"] for k, x in got.items()}
    walls = np.array([0.100, 0.110, 0.120, 0.130, 0.300])
    assert v["setup_s"] == 12.0
    assert v["capture_s"] == pytest.approx(1.5)
    assert v["camera_slots_per_s"] == pytest.approx(200 / 0.8)
    assert v["window_p95_ms"] == pytest.approx(
        1e3 * np.percentile(walls, 95))
    assert v["window_p95_ms"] == pytest.approx(266.0)
    assert v["window_p50_ms"] == pytest.approx(120.0)
    assert v["degraded_windows"] == 1
    assert v["ckpt_snapshot_ms"] == pytest.approx(2.0)
    assert v["device_idle_share"] == pytest.approx(20.0)
    assert v["kernels_per_slot"] == 5 / 16
    tx = kernel_cost.launch_bound_s("tx_codec", (5, 10, 96, 160))
    cc = kernel_cost.launch_bound_s("cc_label", (5, 12, 20))
    tf = kernel_cost.launch_bound_s("threefry_normal", (5, 153600))
    assert v["kernel_roofline"] == pytest.approx(
        100 * (2 * tx + cc + tf) / 44e-6)
    flops = fleet_slot_flops(cell.config)
    assert v["mfu.fleet"] == pytest.approx(
        100 * flops * 200 / 0.8 / 495e12)
    for name, want in EXPECTED.items():
        assert v[name] == pytest.approx(want, rel=1e-12), name
    for m in cell.end_to_end + cell.per_layer:
        assert got[m["name"]]["unit"] == m["unit"]


def test_readers_find_nothing_without_a_trace():
    cell = bench.find_cell(bench.load_benchmark(), "ds16.stream")
    rd = bench.Readings(cell)
    got = bench.read_metrics(cell.per_layer, rd)
    assert not ({"kernels_per_slot", "kernel_roofline", "device_idle_share",
                 "mfu.fleet"} & set(got))


def test_bounds_and_flops():
    # chip_smoke.py's B2 bound at (5, 10, 96, 160): 2.751 us
    assert 1e6 * kernel_cost.launch_bound_s(
        "tx_codec", (5, 10, 96, 160)) == pytest.approx(2.751, abs=1e-3)
    # B1 at (5, 10, 96, 160): 0.930 us
    assert 1e6 * kernel_cost.launch_bound_s(
        "edge_motion", (5, 10, 96, 160, 8)) == pytest.approx(0.930,
                                                              abs=1e-3)
    assert peaks.bound_s(3.35e12, 0) == 1.0
    light = detector_flops((8, 16, 32, 32), 96, 160)
    server = detector_flops((16, 32, 64, 64), 96, 160)
    assert (light, server) == (6_101_760, 23_262_720)
    cfg = bench.find_cell(bench.load_benchmark(), "ds16.stream").config
    assert fleet_slot_flops(cfg) == 2 * light + 3 * server


def test_threefry_normal_bound():
    """The draw at the cell's shape, 16 keys over (10, 96, 160): 5.135 us,
    bound by its operations (140 a value at the float32 rate); bytes and
    operations in the order ``COST`` gives them, which is the reverse of
    the program's ``cost()``."""
    from repro_torch.kernels.threefry_normal import ops
    n = 10 * 96 * 160
    nbytes, n_ops = kernel_cost.threefry_normal(16, n)
    assert (n_ops, nbytes) == ops.cost(16, n)
    assert kernel_cost.THREEFRY_OPS_PER_VALUE == ops.OPS_PER_VALUE
    assert 1e6 * kernel_cost.launch_bound_s(
        "threefry_normal", (16, n)) == pytest.approx(5.135, abs=1e-3)
    assert 1e6 * nbytes / peaks.HBM_BYTES_PER_S == pytest.approx(2.935,
                                                                 abs=1e-3)


def _sha256s(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


STUB_REFERENCE = """
import torch
import torch.nn.functional as F

CALLS = []


def load(config, weights_dir, device):
    g = torch.Generator().manual_seed(7)
    w = int(config["detectors"]["stub_width"])
    return {"c1": torch.randn(w, 1, 3, 3, generator=g).to(device),
            "head": torch.randn(5, w, 1, 1, generator=g).to(device)}


def forward(params, frames, dtype):
    CALLS.append(("forward", tuple(frames.shape), dtype))
    x = torch.relu(F.conv2d(frames[:, None].to(dtype),
                            params["c1"].to(dtype), stride=4, padding=1))
    return F.conv2d(x, params["head"].to(dtype)).permute(0, 2, 3, 1).float()


def decode(raw, conf_thresh, k):
    CALLS.append(("decode", tuple(raw.shape), conf_thresh, k))
    B, Gy, Gx, _ = raw.shape
    scores, idx = torch.sigmoid(raw[..., 0]).reshape(B, -1).topk(k)
    y, x = (idx // Gx).float() * 4, (idx % Gx).float() * 4
    boxes = torch.stack([x, y, x + 12, y + 12], -1)
    return boxes, scores, scores > conf_thresh


def flops(config):
    sc = config["scene"]
    w = int(config["detectors"]["stub_width"])
    cells = -(-int(sc["height"]) // 4) * -(-int(sc["width"]) // 4)
    return 2 * w * 9 * cells + 2 * 5 * w * cells
"""

STUB_PROGRAM = """
import torch


def build(device, width):
    g = torch.Generator().manual_seed(7)
    return {"c1": torch.randn(width, 1, 3, 3, generator=g).to(device),
            "head": torch.randn(5, width, 1, 1, generator=g).to(device)}
"""


def test_a_server_detector_is_files_and_entries(tmp_path, monkeypatch):
    """A cell whose configuration names a server detector of another
    architecture (a two-conv stub): its configuration, its reference
    module and the program's builder are new files and its cell a new
    entry.  The cell resolves, the program is built with the builder's
    parameters, the reference runs the stub's forward and decode on a
    CPU slot, ``mfu.fleet`` counts the stub's FLOPs, and no file that was
    in the benchmark's folder changes."""
    import numpy as np
    import torch
    from perfbench.reference import fleet as ref_fleet
    root = tmp_path / "checkout"
    shutil.copytree(bench.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _sha256s(root / "perfbench")
    cfg = json.loads((bench.ROOT / "perfbench/configs/deepstream_c5.json")
                     .read_text())
    cfg["name"] = "deepstream_stub"
    cfg["scene"]["num_cameras"] = 2
    cfg["detectors"].update(server_arch="stub2",
                            server_program="stub2_program:build",
                            server_program_args={"width": 4},
                            stub_width=4)
    (root / "perfbench/configs/deepstream_stub.json").write_text(
        json.dumps(cfg))
    (root / "perfbench/reference/detectors/stub2.py").write_text(
        STUB_REFERENCE)
    (tmp_path / "program").mkdir()
    (tmp_path / "program/stub2_program.py").write_text(STUB_PROGRAM)
    monkeypatch.syspath_prepend(str(tmp_path / "program"))
    b = bench.load_benchmark()
    b["configs"].append({"name": "deepstream_stub", "source": "x",
                         "file": "perfbench/configs/deepstream_stub.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "dsstub.stream",
                           "config": "deepstream_stub", "traffic": "stream",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "mfu.fleet.stub", "unit": "%",
                           "better": "higher", "source": "host_clock",
                           "layer": "whole slot",
                           "moves": "camera_slots_per_s",
                           "workloads": ["dsstub.stream"]})
    shutil.copy(root / "perfbench/metrics/mfu.fleet.py",
                root / "perfbench/metrics/mfu.fleet.stub.py")
    cell = bench.find_cell(b, "dsstub.stream", root=root)
    assert cell.config["detectors"]["server_arch"] == "stub2"
    assert [m["name"] for m in cell.per_layer] == ["mfu.fleet.stub"]

    driver = bench.driver_of(cell)
    system, runner, ckpt_dir = driver.build(cell, 5, "cpu")
    try:
        want = importlib.import_module("stub2_program").build("cpu", 4)
        assert set(system.server) == set(want)
        for k in want:
            assert torch.equal(system.server[k], want[k]), k
    finally:
        runner.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    detectors_dir = root / "perfbench/reference/detectors"
    ref = ref_fleet.FleetReference(cell.config, 5, "cpu",
                                   bench.ROOT / "artifacts",
                                   detectors_dir=detectors_dir)
    stub = ref.server_arch
    assert stub.__file__ == str(detectors_dir / "stub2.py")
    C, F_ = 2, int(cfg["system"]["eval_frames"])
    pack, _, _ = ref.slot(0, 2000.0, np.ones(C, bool),
                          ref_fleet.elastic_init("cpu"), np.ones(C, bool))
    assert pack.shape == (2, C) and torch.isfinite(pack).all()
    assert stub.CALLS == [
        ("forward", (C * F_, 96, 160), torch.float32),
        ("decode", (C * F_, 24, 40, 5), cfg["control"]["server_conf_thresh"],
         16)]

    light = detector_flops(cfg["detectors"]["light_widths"], 96, 160)
    per_slot = fleet_slot_flops(cell.config, cell.bench_dir)
    assert per_slot == 2 * light + F_ * stub.flops(cell.config)
    assert per_slot != fleet_slot_flops(
        json.loads((bench.ROOT / "perfbench/configs/deepstream_c5.json")
                   .read_text()))
    rd = bench.Readings(cell, counters={"camera_slots": 100,
                                        "cudnn_allow_tf32": True})
    rd.span("window", 0.0, 2.0)
    got = bench.read_metrics(cell.per_layer, rd)
    assert got["mfu.fleet.stub"]["value"] == pytest.approx(
        100 * per_slot * 50 / 495e12)

    after = _sha256s(root / "perfbench")
    assert {p: after[p] for p in before} == before


def test_result_line_schema():
    cell = bench.find_cell(bench.load_benchmark(), "ds16.stream")
    rd = _readings(cell)
    checks = [bench.Check("log_gap", 0.0, 1e-3),
              bench.Check("slots_compared", 192.0, 192.0, at_most=False)]
    out = bench.Outcome(rd, checks, attempted=5, failed=0,
                        memory_peak_bytes=123, device_kind="NVIDIA H100",
                        device_count=1)
    for trace in (False, True):
        metrics = bench.read_metrics(
            cell.per_layer if trace else cell.end_to_end, rd)
        line = json.loads(json.dumps(bench.result_line(out, metrics, trace)))
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[:5] == keys and list(line)[-1] == "check"
        assert line["correct"] is True
        assert line["device"]["platform"] == "gpu"
        assert set(line["device"]) >= {"kind", "count", "memory_peak_bytes"}
        assert ("busy_s" in line["device"]) == trace
        assert ("breakdown" in line) == trace
        if trace:
            bd = line["breakdown"]
            assert len(bd["device_ops"]) <= 10
            assert bd["idle_gaps"][0] == [
                "perfbench.offer+serve/cudaGraphLaunch", 0.07]
        assert line["check"]["log_gap"] == {"value": 0.0, "limit": 1e-3}
    bad = bench.Outcome(rd, [bench.Check("log_gap", 0.5, 1e-3)], 5, 0, 1,
                        "x", 1)
    assert bench.result_line(bad, {}, False)["correct"] is False
    assert not bench.Check("log_gap", math.nan, 1.0).ok
    assert not bench.Check("log_gap", 0.0, None).ok


def test_forbidden_modules_compare_whole_names():
    assert bench.forbidden_loaded({"repro_torch": 1, "repro_torch.x": 1,
                                   "reprox": 1, "jaxtyping": 1}) == []
    assert bench.forbidden_loaded({"repro.core.fleet": 1, "jax": 1,
                                   "jaxlib.xla": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib", "repro"]


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_read_trace_busy_and_idle_gaps():
    trace = {"traceEvents": [
        _ev(devtrace.SPAN, "user_annotation", 0, 1000),
        _ev("perfbench.offer+serve", "user_annotation", 0, 600),
        _ev("cudaGraphLaunch", "cuda_runtime", 100, 300),
        _ev("aten::copy_", "cpu_op", 700, 100),
        _ev("k1", "kernel", 50, 100, tid=7),
        _ev("k2", "kernel", 120, 80, tid=7),      # overlaps k1
        _ev("Memcpy", "gpu_memcpy", 500, 100, tid=8),
        _ev("k3", "kernel", 900, 200, tid=7),     # runs past the span
        _ev("k0", "kernel", -300, 100, tid=7),    # before the span
    ]}
    dt = devtrace.read_trace(trace)
    assert dt.window_s == pytest.approx(1e-3)
    # busy: [50, 200) + [500, 600) + [900, 1000)
    assert dt.busy_s == pytest.approx(350e-6)
    assert [k for k, _ in dt.kernels] == ["k1", "k2", "k3"]
    gaps = dict(dt.idle_gaps)
    # [0, 50): inside the annotation, no host call; [200, 500): the graph
    # launch at its middle; [600, 900): the copy at its middle
    assert gaps == pytest.approx({
        "perfbench.offer+serve": 50e-6,
        "perfbench.offer+serve/cudaGraphLaunch": 300e-6,
        "aten::copy_": 300e-6})


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 7])
def test_traffic_copies_equal_the_ports(seed):
    from repro_torch.data import scenarios as port
    for C in (5, 16):
        tr, lv = make_soak_stream(1000, num_cams=C, seed=seed)
        ptr, plv = port.make_soak_stream(1000, num_cams=C, seed=seed)
        np.testing.assert_array_equal(tr, ptr)
        np.testing.assert_array_equal(lv, plv)
    for fam in TRACE_FAMILIES:
        np.testing.assert_array_equal(make_trace(fam, 50, seed, 16),
                                      port.make_trace(fam, 50, seed, 16))
    for fam in FAULT_FAMILIES:
        np.testing.assert_array_equal(make_faults(fam, 40, 6, seed),
                                      port.make_faults(fam, 40, 6, seed))


def test_make_stream_reads_the_traffic_file():
    traffic = json.loads((bench.BENCH_DIR / "traffic/stream.json")
                         .read_text())
    tr, lv = make_stream(traffic, 16, 5)
    ptr, plv = make_soak_stream(1000, num_cams=16, seed=5)
    np.testing.assert_array_equal(tr, ptr)
    np.testing.assert_array_equal(lv, plv)
    with pytest.raises(ValueError, match="generator"):
        make_stream({"generator": "nope"}, 5, 0)
