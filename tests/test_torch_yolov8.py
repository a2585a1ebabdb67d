"""YOLOv8s as the fleet's server detector (``models/yolov8.py``) on the
CPU: the published counts, the BN fold, the letterbox, DFL and
``dist2bbox``, the capped NMS against a full one, and the detector on the
fleet's normal path (the slot finish's dispatch, the episode's static
buffers and graph key, the system and the launcher).  The comparison with
the benchmark's plain reference is ``perfbench/test_perfbench_yolov8s.py``."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.common import prng
from repro_torch.core import fleet
from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
from repro_torch.core.utility import init_utility_mlp
from repro_torch.data.scenarios import make_soak_stream
from repro_torch.data.synthetic import DeviceScene, SceneConfig
from repro_torch.models import yolov8
from repro_torch.models.detector import load_detector

SMALL = (96, 160)        # imgsz at the frames' own size: the CPU's


@pytest.fixture(scope="module")
def small():
    return yolov8.build(imgsz=SMALL)


def param_count(scale: str) -> int:
    """Learnable parameters as published, BN unfolded: every kernel, BN's
    weight and bias, the head's last biases (DFL's fixed bins not
    counted)."""
    return sum(c.cout * c.cin * c.k * c.k + c.cout * (2 if c.bn else 1)
               for c in yolov8.architecture(scale)[1])


def conv_flops(scale: str, imgsz) -> int:
    """2 x the multiply-adds of every convolution of one frame at
    ``imgsz``, each at its layer's output size, as Ultralytics counts."""
    layers, _ = yolov8.architecture(scale)
    macs = lambda c, hw: c.cout * c.cin * c.k * c.k * hw[0] * hw[1]
    hw, sizes, total = tuple(imgsz), [], 0
    for kind, _, a in layers:
        if kind == "conv":
            hw = (hw[0] // a.stride, hw[1] // a.stride)
            total += macs(a, hw)
        elif kind == "c2f":
            cv1, m, cv2, _ = a
            total += sum(macs(c, hw) for c in [cv1, cv2] + [b for p in m
                                                           for b in p])
        elif kind == "sppf":
            total += macs(a[0], hw) + macs(a[1], hw)
        elif kind == "up":
            hw = (2 * hw[0], 2 * hw[1])
        elif kind == "cat":
            hw = sizes[a[0]]
        else:
            feats, box, cls = a
            total += sum(macs(c, sizes[f]) for f, b, k in zip(feats, box, cls)
                         for c in b + k)
        sizes.append(hw)
    return 2 * total


def test_published_counts():
    assert param_count("s") == 11_166_544
    assert param_count("s") + yolov8.REG_MAX == 11_166_560
    assert conv_flops("s", (640, 640)) == 28_601_548_800
    assert conv_flops("s", (384, 640)) == 17_160_929_280
    layers, convs = yolov8.architecture("s")
    assert len(layers) == 23 and layers[-1][0] == "detect"
    assert [c.cout for c in convs if c.name in ("0", "1", "3", "5", "7")] == \
        [32, 64, 128, 256, 512]
    with pytest.raises(ValueError, match="scale"):
        yolov8.architecture("x")


def test_folded_equals_conv_bn_silu():
    g = torch.Generator().manual_seed(3)
    w = torch.randn((16, 8, 3, 3), generator=g)
    p = {"w": w, "gamma": torch.rand(16, generator=g) + 0.5,
         "beta": torch.randn(16, generator=g),
         "mean": torch.randn(16, generator=g),
         "var": torch.rand(16, generator=g) + 0.1}
    x = torch.randn((2, 8, 12, 20), generator=g)
    y = F.conv2d(x, w, None, stride=2, padding=1)
    want = F.silu(F.batch_norm(y, p["mean"], p["var"], p["gamma"],
                               p["beta"], training=False, eps=1e-3))
    wf, bf = yolov8.fold(p)
    got = F.silu(F.conv2d(x, wf, bf, stride=2, padding=1))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_seeded_weights_are_the_seeds_and_bn_is_calibrated():
    a = yolov8.init_params("s", SMALL, SMALL, 0, -4.0)
    b = yolov8.init_params("s", SMALL, SMALL, 0, -4.0)
    c = yolov8.init_params("s", SMALL, SMALL, 1, -4.0)
    assert all(torch.equal(a[k][q], b[k][q]) for k in a for q in a[k])
    assert not torch.equal(a["0"]["w"], c["0"]["w"])
    for name, p in a.items():
        if "gamma" in p:
            assert (p["var"] > 0).all() and torch.isfinite(p["mean"]).all()
        else:
            assert set(p) == {"w", "b"}
    assert torch.equal(a["22.cv3.1.2"]["b"], torch.full((80,), -4.0))
    # each side's 16 box logits peak at the level's bin
    assert int(a["22.cv2.0.2"]["b"][:16].argmax()) == 3
    assert int(a["22.cv2.1.2"]["b"][16:32].argmax()) == 2


def test_letterbox_shape_and_values():
    det = yolov8.build()
    g = torch.Generator().manual_seed(0)
    frames = torch.rand((2, 96, 160), generator=g)
    x = det.letterbox(frames)
    assert x.shape == (2, 3, 384, 640)
    assert torch.equal(x[:, 0], x[:, 1]) and torch.equal(x[:, 0], x[:, 2])
    # half-pixel centres at x 4: output row 2 samples source row 0.125
    # (7/8 of row 0, 1/8 of row 1), output column 5 source column 0.875
    f = frames[0]
    want = (0.875 * (0.125 * f[0, 0] + 0.875 * f[0, 1])
            + 0.125 * (0.125 * f[1, 0] + 0.875 * f[1, 1]))
    assert float(x[0, 0, 2, 5]) == pytest.approx(float(want), abs=1e-6)
    flat = det.letterbox(torch.full((1, 96, 160), 0.3))
    assert torch.allclose(flat, torch.full_like(flat, 0.3))
    with pytest.raises(ValueError, match="frames"):
        det.forward(torch.zeros((1, 48, 80)))
    with pytest.raises(ValueError, match="imgsz"):
        yolov8.build(imgsz=(100, 160))


def test_dfl_and_dist2bbox_on_a_built_case():
    A = 2
    anchors = torch.tensor([[0.5, 3.5], [0.5, 1.5]])      # (x; y) in strides
    strides = torch.tensor([[8.0, 16.0]])
    logits = torch.full((1, 64 + 80, A), -30.0)
    sides = ((2, 1, 4, 3), (0, 5, 1, 2))                  # l, t, r, b bins
    for a, bins in enumerate(sides):
        for s, j in enumerate(bins):
            logits[0, 16 * s + j, a] = 30.0
    logits[0, 64 + 7, 1] = 2.0
    out = yolov8.head_output(logits, anchors, strides,
                             torch.arange(16, dtype=torch.float32))
    assert out.shape == (1, 84, A)
    # anchor 0: x1 = 0.5 - 2, x2 = 0.5 + 4; y1 = 0.5 - 1, y2 = 0.5 + 3;
    # anchor 1: x1 = 3.5 - 0, x2 = 3.5 + 1; y1 = 1.5 - 5, y2 = 1.5 + 2
    want0 = torch.tensor([1.5 * 8, 1.5 * 8, 6 * 8, 4 * 8])
    want1 = torch.tensor([4.0 * 16, 0.0, 1 * 16, 7 * 16])
    assert torch.allclose(out[0, :4, 0], want0, atol=1e-4)
    assert torch.allclose(out[0, :4, 1], want1, atol=1e-4)
    assert float(out[0, 4 + 7, 1]) == pytest.approx(float(torch.sigmoid(
        torch.tensor(2.0))))
    assert float(out[0, 4:, 0].max()) < 1e-12


def _full_greedy(boxes_xyxy, scores, conf, iou):
    """Greedy NMS over every anchor that passes ``conf``, best first
    (stable), on the host: the kept anchors' indices in order."""
    order = np.argsort(-scores, kind="stable")
    order = [int(i) for i in order if scores[i] > conf]
    kept = []
    for i in order:
        b = torch.as_tensor(boxes_xyxy[[i] + kept])
        if kept:
            from repro_torch.models.detector import box_iou
            if (box_iou(b[:1], b[1:]) > iou).any():
                continue
        kept.append(i)
    return kept


def _built_raw(B=6, A=300, seed=5):
    """Raw outputs in 384 x 640 pixels: random boxes and scores; frame 0
    holds 100 copies of one box and nothing else that passes (one kept of
    64 candidates while 100 pass: an overflow), frame 1 has 10 anchors
    passing."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((B, 2, A), generator=g) * torch.tensor([[640.], [384.]])
    wh = 20 + 80 * torch.rand((B, 2, A), generator=g)
    cls = torch.rand((B, 80, A), generator=g) * 0.3
    cls[:, 3] = torch.rand((B, A), generator=g)
    xy[0, :, :100] = torch.tensor([[200.0], [100.0]])
    wh[0, :, :100] = 60.0
    cls[0, 3, :100] = 0.9 + 0.05 * torch.rand(100, generator=g)
    cls[0, :, 100:] = 0.2
    cls[1] = torch.where(torch.arange(A) < 10, cls[1], 0.1)
    return torch.cat([xy, wh, cls], 1)


def test_capped_nms_equals_full_nms_and_counts_overflow():
    spec = yolov8.Spec(imgsz=(384, 640), nms_candidates=64)
    raw = _built_raw()
    boxes, scores, valid, overflow = yolov8.nms_decode(raw, 0.25, 16, spec)
    xyxy = yolov8.xywh2xyxy(raw[:, :4].transpose(1, 2)).numpy()
    s = raw[:, 4:].amax(1).numpy()
    over = 0
    for b in range(raw.shape[0]):
        full = _full_greedy(xyxy[b], s[b], 0.25, 0.7)
        rank = {int(i): r for r, i in enumerate(
            np.argsort(-s[b], kind="stable"))}
        n_pass = int((s[b] > 0.25).sum())
        got = valid[b].sum().item()
        if got < 16 and n_pass > 64:
            over += 1
            continue
        # the capped NMS's first 16 are full NMS's whenever its 16th keep
        # (or its last, with fewer) lies among the 64 candidates
        want = full[:16]
        assert all(rank[i] < 64 for i in want)
        assert got == len(want)
        want_boxes = np.clip(xyxy[b][want] / 4, 0, [160, 96, 160, 96])
        np.testing.assert_allclose(boxes[b, :got].numpy(), want_boxes,
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(scores[b, :got].numpy(), s[b][want])
    assert over == int(overflow) == 1
    assert int(valid[0].sum()) == 1 and int(valid[1].sum()) <= 10


def test_server_ops_dispatch_by_type(small):
    conv4 = load_detector("server", "cpu")
    frames = torch.rand((2, 96, 160), generator=torch.Generator()
                        .manual_seed(1))
    ops = fleet.server_ops(conv4)
    assert ops.conf == fleet.CONV4_CONF == 0.4
    from repro_torch.models import detector as det
    grid = det.forward(conv4, frames)
    assert torch.equal(ops.forward(frames), grid)
    got, want = ops.decode(grid, 0.4, 16), det.decode_boxes(grid, 0.4)
    assert got[3] is None
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want))
    ops = fleet.server_ops(small)
    assert ops.conf == yolov8.CONF == 0.25
    raw = ops.forward(frames)
    assert raw.shape == (2, 84, 12 * 20 + 6 * 10 + 3 * 5)
    assert torch.equal(raw, small.forward(frames))
    out = ops.decode(raw, 0.25, 16)
    assert [tuple(x.shape) for x in out[:3]] == [(2, 16, 4), (2, 16),
                                                 (2, 16)]
    assert out[3].dtype == torch.int64 and out[3].dim() == 0


def test_the_detector_rides_the_episode_buffers(small):
    """``_map`` keeps the detector's type (the graphs' static copy runs
    its own calls), ``_leaves`` holds its tensors, and its statics are in
    the graph key."""
    cloned = fleet._map(torch.clone, small)
    assert isinstance(cloned, yolov8.YOLOv8) and cloned.spec == small.spec
    assert cloned.params["0.w"] is not small.params["0.w"]
    n = len(small.params) + 3
    assert len(fleet._leaves(small)) == n
    other = small._replace(spec=dataclasses.replace(small.spec, iou=0.5))
    keys = []
    for server in (small, other, load_detector("server", "cpu")):
        s = DeepStreamSystem(_cfg(2), load_detector("light", "cpu"), server,
                             device="cpu")
        kw = s._episode_kwargs(DeviceScene(s.cfg.scene, device="cpu"),
                               np.full(2, 2000.0), "deepstream")
        keys.append(fleet.episode_inputs("deepstream", **kw).statics)
    assert keys[0].server_spec == small.spec
    assert keys[0].conf_thresh == 0.25 and keys[2].conf_thresh == 0.4
    assert keys[2].server_spec is None
    assert len({keys[0], keys[1], keys[2]}) == 3


def _cfg(C):
    return SystemConfig(scene=SceneConfig(seed=4, num_cameras=C),
                        episode=True, eval_frames=2, w_cap_kbps=8000.0)


def _system(cfg, server):
    s = DeepStreamSystem(cfg, load_detector("light", "cpu"), server,
                         device="cpu")
    s.mlp = init_utility_mlp(prng.PRNGKey(0, device="cpu"))
    s.tau_wl, s.tau_wh = 10.0, 50.0
    return s


def test_episode_and_slot_step_use_the_detectors_calls(small):
    """The episode (pipelined and reference body) and the fleet slot step
    with YOLOv8 score the slot's frames with its forward and decode: the
    pipelined logs equal the reference body's and the F1 the detector's
    own boxes give."""
    C, T = 2, 2
    trace_kbps, live = make_soak_stream(T, num_cams=C, seed=3)
    logs = []
    for pipelined in (True, False):
        cfg = dataclasses.replace(_cfg(C), episode_pipelined=pipelined)
        s = _system(cfg, small)
        assert s.server is not small and isinstance(s.server, yolov8.YOLOv8)
        logs.append(s.run_episode(DeviceScene(cfg.scene, device="cpu"),
                                  trace_kbps, "deepstream", faults=live))
    for k in logs[0]:
        np.testing.assert_array_equal(logs[0][k], logs[1][k], err_msg=k)
    assert np.isfinite(logs[0]["mean_f1"]).all()
    calls = []
    orig = yolov8.YOLOv8.decode

    def decode(self, raw, conf, k=16):
        calls.append(conf)
        return orig(self, raw, conf, k)
    yolov8.YOLOv8.decode = decode
    try:
        s.run_episode(DeviceScene(_cfg(C).scene, device="cpu"), trace_kbps,
                      "deepstream", faults=live)
        frames = torch.rand((C, 10, 96, 160))
        out = s.fleet_encode_eval(frames, [[[] for _ in range(10)]] * C,
                                  None, np.full(C, 400.0), np.ones(C))[2]
    finally:
        yolov8.YOLOv8.decode = orig
    assert calls == [0.25] * (T + 1)
    assert out.overflow is not None and out.f1.shape == (C,)


def test_launcher_builds_either_detector():
    from repro_torch.launch import serve
    assert isinstance(serve.server_detector("conv4", "cpu"), dict)
    det = serve.server_detector("yolov8s", "cpu")
    assert det.spec == yolov8.Spec() and det.spec.imgsz == (384, 640)
