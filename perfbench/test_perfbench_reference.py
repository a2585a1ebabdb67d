"""The benchmark's plain reference (``perfbench/reference/fleet.py``)
against the port's CPU episode at a tiny size: the stream runner's logs
over windows with dead and rejoining cameras, carried across windows,
equal the reference's slot by slot."""
import numpy as np
import torch

from perfbench.conftest import TINY_SEED, tiny
from perfbench.core import bench
from perfbench.drivers import fleet_stream as fs
from perfbench.reference import fleet as ref_fleet

torch.set_num_threads(1)


def test_reference_equals_the_ports_cpu_stream():
    cell = tiny(bench.find_cell(bench.load_benchmark(), "ds16.stream"),
                cameras=3)
    n = cell.config["stream"]["window_slots"]
    stream = fs.Stream(cell.traffic, 3, TINY_SEED)
    # camera 2 dead in slot 1, back in slot 2 (a reconnect inside the
    # carried chain), camera 1 dead in slot 3
    stream.live[:4] = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1], [1, 0, 1]],
                               bool)
    system, runner, ckpt_dir = fs.build(cell, TINY_SEED, "cpu")
    try:
        for t in range(0, 2 * n, n):
            assert fs.serve_window(runner, stream, t, n) == n
    finally:
        runner.close()
    prog = fs.program_logs(runner.logs, [0, 1], n)
    ref = fs.reference_logs(cell, TINY_SEED, "cpu", stream, [0, 1], n,
                            np.asarray(runner.logs["area"]))
    for k in ref_fleet.LOG_KEYS:
        np.testing.assert_array_equal(prog[k], ref[k], err_msg=k)
    assert prog["bytes"][1] > 0 and prog["mean_f1"].max() > 0
    # a window alone, its elastic state replayed from the logged areas
    alone = fs.reference_logs(cell, TINY_SEED, "cpu", stream, [1], n,
                              np.asarray(runner.logs["area"]))
    for k in ref_fleet.LOG_KEYS:
        np.testing.assert_array_equal(alone[k], ref[k][n:], err_msg=k)


def test_compare_scales_each_key():
    keys = ref_fleet.LOG_KEYS
    ref = {k: np.array([1.0, 2.0]) for k in keys}
    prog = {k: v.copy() for k, v in ref.items()}
    assert max(ref_fleet.compare(prog, ref).values()) == 0.0
    prog["area"] = np.array([1.0, 2.5])
    assert ref_fleet.compare(prog, ref)["area"] == 0.25
    prog["W"] = np.array([np.nan, 2.0])
    assert fs.log_gap(ref_fleet.compare(prog, ref)) == 1e300
    assert ref_fleet.compare({**prog, "extra": np.zeros(3)},
                             ref)["extra"] == float("inf")


def test_sample_windows_keeps_the_start_and_the_end():
    w = fs.sample_windows(300, 3, 24, TINY_SEED)
    assert len(w) == 24 and w[:3] == [0, 1, 2] and w[-1] == 299
    assert w == fs.sample_windows(300, 3, 24, TINY_SEED)
    assert w != fs.sample_windows(300, 3, 24, TINY_SEED + 1)
    assert fs.sample_windows(4, 3, 24, 1) == [0, 1, 2, 3]


def test_conv4_module_gives_the_programs_bits():
    """``reference/detectors/conv4.py`` at a small size: the server
    checkpoint as the program loads it, and its forward and decode
    bitwise the program's ``detector.forward`` and ``decode_boxes``."""
    from repro_torch.models import detector
    from perfbench.reference.detectors import conv4, server_module
    cfg = bench.find_cell(bench.load_benchmark(), "ds16.stream").config
    assert server_module(cfg) is conv4
    params = conv4.load(cfg, bench.ROOT / "artifacts", "cpu")
    prog = detector.load_detector("server", "cpu")
    assert set(params) == set(prog)
    for k in prog:
        assert torch.equal(params[k], prog[k]), k
    g = torch.Generator().manual_seed(11)
    frames = torch.rand((3, 48, 80), generator=g)
    raw = conv4.forward(params, frames, torch.float32)
    assert torch.equal(raw, detector.forward(prog, frames))
    got = conv4.decode(raw, 0.4, 16)
    want = detector.decode_boxes(raw, conf_thresh=0.4, k=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert conv4.flops(cfg) == 23_262_720
