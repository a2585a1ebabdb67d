"""The ``yolov8s`` server detector's plain reference
(``reference/detectors/yolov8s.py``) against the program's
(``repro_torch.models.yolov8``) on the CPU, at the published widths on
the seeded weights, 2 frames at ``imgsz`` [96, 160]; the bfloat16
control and two planted faults; and a tiny copy of ``ds16.yolov8s.stream``
(2 cameras, ``imgsz`` [96, 160]) through the fleet-stream harness's build,
run and check."""
import copy
import dataclasses
import shutil

import pytest
import torch

from perfbench.conftest import TINY_SEED, tiny
from perfbench.core import bench
from perfbench.core.flops import fleet_slot_flops
from perfbench.drivers import fleet_stream as fs
from perfbench.reference.detectors import server_module

torch.set_num_threads(1)
CELL = "ds16.yolov8s.stream"
SMALL = [96, 160]


def small_config():
    cfg = copy.deepcopy(bench.find_cell(bench.load_benchmark(), CELL).config)
    cfg["detectors"]["server_program_args"]["imgsz"] = list(SMALL)
    return cfg


@pytest.fixture(scope="module")
def pair():
    """(config, reference module, its parameters, the program's detector,
    two of the scene's frames)."""
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            segments_device)
    cfg = small_config()
    ref = server_module(cfg)
    params = ref.load(cfg, bench.ROOT / "artifacts", "cpu")
    prog = fs.server_detector(cfg, "cpu")
    scene = DeviceScene(SceneConfig(seed=5, num_cameras=2), device="cpu")
    frames = segments_device(scene.cfg, scene.params, scene.key, 4,
                             gt_pad=scene.G)[0][:, 0]
    return cfg, ref, params, prog, frames


def kept_boxes(boxes, valid):
    return [boxes[b][valid[b]] for b in range(boxes.shape[0])]


def same_kept(a, b) -> bool:
    return all(x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(kept_boxes(*a), kept_boxes(*b)))


def rel_gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def test_flops_and_the_configuration():
    cfg = bench.find_cell(bench.load_benchmark(), CELL).config
    det = cfg["detectors"]
    assert det["server_arch"] == "yolov8s"
    assert det["server_program"] == "repro_torch.models.yolov8:build_server"
    assert det["server_program_args"]["imgsz"] == [384, 640]
    assert cfg["control"]["server_conf_thresh"] == 0.25
    assert cfg["reduced"] == []
    ref = server_module(cfg)
    assert ref.flops(cfg) == 17_160_929_280
    square = copy.deepcopy(cfg)
    square["detectors"]["server_program_args"]["imgsz"] = [640, 640]
    assert ref.flops(square) == 28_601_548_800
    assert fleet_slot_flops(cfg) == 2 * 6_101_760 + 3 * 17_160_929_280
    n = sum(c_out * c_in * k * k + c_out * (2 if bn else 1)
            for _, c_in, c_out, k, bn in ref.conv_table())
    assert n == 11_166_544


def test_program_equals_the_reference(pair):
    cfg, ref, params, prog, frames = pair
    raw = ref.forward(params, frames, torch.float32)
    got = prog.forward(frames)
    assert got.shape == raw.out.shape == (2, 84, 315)
    assert rel_gap(got, raw.out) <= 1e-5
    conf = cfg["control"]["server_conf_thresh"]
    want = ref.decode(raw, conf, 16)
    mine = prog.decode(got, conf, 16)
    assert int(want[2].sum()) > 0
    assert same_kept((mine[0], mine[2]), (want[0], want[2]))


def test_the_bfloat16_control_fails(pair):
    cfg, ref, params, prog, frames = pair
    f32 = ref.forward(params, frames, torch.float32)
    bf16 = ref.forward(params, frames, torch.bfloat16)
    assert rel_gap(bf16.out, f32.out) > 1e-5
    conf = cfg["control"]["server_conf_thresh"]
    a, b = ref.decode(f32, conf, 16), ref.decode(bf16, conf, 16)
    assert not same_kept((a[0], a[2]), (b[0], b[2]))


def nms_at_045(det):
    return det._replace(spec=dataclasses.replace(det.spec, iou=0.45))


def dfl_reversed(det):
    return det._replace(bins=det.bins.flip(0))


@pytest.mark.parametrize("fault", [nms_at_045, dfl_reversed])
def test_a_planted_fault_in_the_detector_is_seen(pair, fault):
    cfg, ref, params, prog, frames = pair
    conf = cfg["control"]["server_conf_thresh"]
    want = ref.decode(ref.forward(params, frames, torch.float32), conf, 16)
    bad = fault(prog)
    got = bad.decode(bad.forward(frames), conf, 16)
    assert not same_kept((got[0], got[2]), (want[0], want[2]))


def test_a_tiny_copy_of_the_cell_is_correct():
    cell = tiny(bench.find_cell(bench.load_benchmark(), CELL))
    cell.config["detectors"]["server_program_args"]["imgsz"] = list(SMALL)
    system, runner, ckpt_dir = fs.build(cell, TINY_SEED, "cpu")
    try:
        from repro_torch.models.yolov8 import YOLOv8
        assert isinstance(system.server, YOLOv8)
        assert system.server.spec.imgsz == tuple(SMALL)
    finally:
        runner.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = fs.run(cell, TINY_SEED, 0.0, True, "cpu", 0.0, max_windows=2)
    line = bench.result_line(out, {}, False)
    assert line["correct"] is True, line["check"]
    assert line["check"]["log_gap"]["value"] == 0.0
    assert out.attempted == 3 and out.failed == 0
    got = bench.read_metrics(cell.per_layer + cell.end_to_end, out.readings)
    # the stage marks, and so the detector's spans, exist only on the card
    assert not {"stage_detect_ms", "stage_decode_ms", "mfu.detect",
                "nms_overflow_frames"} & set(got)
    assert got["mfu.fleet"]["value"] > 0
