"""The port's span recorder (``repro_torch.common.trace``), its spans in
the fleet stream, the episode graphs' stage marks
(``kernels/stage_stamp``) and the launcher's ``--trace``.

The CPU tests hold the recorder's rules (nothing recorded while it is
inactive; nesting, windows and threads; the profiler's annotations), the
span tree of one served window with its checkpoint, and logs bitwise
equal with tracing on and off.  The ``cuda`` tests hold the graphed
episode with its marks to the eager body, the marks' order, and the
graph count with tracing on; this file imports no JAX, so they run on a
card with ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_trace.py``."""
import json
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro_torch.common import device as t_device  # noqa: E402
from repro_torch.common import prng, trace  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core.utility import init_utility_mlp  # noqa: E402
from repro_torch.data.scenarios import make_soak_stream  # noqa: E402
from repro_torch.data.synthetic import DeviceScene, SceneConfig  # noqa
from repro_torch.kernels.stage_stamp import ops as stamp_ops  # noqa: E402
from repro_torch.models.detector import load_detector  # noqa: E402
from repro_torch.serve.stream import (LOG_KEYS, StreamConfig,  # noqa: E402
                                      StreamingFleetRunner)

C = 2
WINDOW = 2


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Every test starts and ends with an empty, disabled recorder."""
    trace.enable(False)
    trace.clear()
    yield
    trace.enable(False)
    trace.clear()


def _system(device, num_cameras=C):
    cfg = t_sched.SystemConfig(
        scene=SceneConfig(seed=33, num_cameras=num_cameras), episode=True,
        eval_frames=3, w_cap_kbps=8000.0)
    s = t_sched.DeepStreamSystem(cfg, load_detector("light", device),
                                 load_detector("server", device),
                                 device=device)
    s.mlp = init_utility_mlp(prng.PRNGKey(0, device=device))
    s.tau_wl, s.tau_wh = 10.0, 50.0
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(
        np.float32)
    return s


def _stream(T, num_cameras=C):
    return make_soak_stream(T, num_cams=num_cameras, seed=5)


def _runner(tmp_path, name):
    s = _system("cpu")
    return StreamingFleetRunner(
        s, DeviceScene(s.cfg.scene, device="cpu"),
        cfg=StreamConfig(window_slots=WINDOW, ckpt_dir=str(tmp_path / name),
                         ckpt_keep=1))


def _serve(runner, windows):
    trace_kbps, live = _stream(windows * WINDOW)
    for w in range(windows):
        sl = slice(w * WINDOW, (w + 1) * WINDOW)
        runner.offer(trace_kbps[sl], faults=live[sl])
        runner.serve()
    runner.close()
    return {k: np.asarray(v) for k, v in runner.logs.items()}


# -- the recorder ------------------------------------------------------------

def test_nothing_is_recorded_while_inactive():
    assert not trace.active()
    assert trace.span("a") is trace.span("b", window=3)   # one null context
    with trace.span("a") as sp:
        assert sp is None
    with trace.timer("t") as tm:
        pass
    assert tm.seconds >= 0.0
    trace.record("stage.synth", 0.0, 1.0, clock="device")
    trace.count("c")
    trace.count("c", 2)
    assert trace.spans() == []
    assert trace.counts() == {"c": 3}


def test_the_store_keeps_the_newest_spans():
    trace.enable()
    for i in range(trace.MAX_SPANS + 10):
        trace.record("s", float(i), float(i))
    got = trace.spans()
    assert len(got) == trace.MAX_SPANS
    assert got[0].t0 == 10.0 and got[-1].t0 == trace.MAX_SPANS + 9.0


def test_spans_nest_with_parents_windows_and_threads():
    trace.enable()
    seen = {}

    def writer():
        with trace.span("w.outer", window=7):
            with trace.span("w.inner"):
                pass
        seen["thread"] = threading.get_ident()

    with trace.span("root", window=3):
        with trace.timer("child") as tm:
            trace.record("dev", 5.0, 5.25, clock="device", slot=11)
        th = threading.Thread(target=writer)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    by = {sp.name: sp for sp in trace.spans()}
    assert set(by) == {"root", "child", "dev", "w.outer", "w.inner"}
    assert by["root"].parent is None and by["root"].window == 3
    assert by["child"].parent == by["root"].id and by["child"].window == 3
    assert by["child"].seconds == tm.seconds
    assert by["dev"].parent == by["child"].id and by["dev"].window == 3
    assert by["dev"].clock == "device" and by["dev"].ids == {"slot": 11}
    assert by["dev"].seconds == 0.25
    # another thread's spans: their own stack and the window handed over
    assert by["w.outer"].parent is None and by["w.outer"].window == 7
    assert by["w.inner"].parent == by["w.outer"].id
    assert by["w.inner"].window == 7
    assert by["w.outer"].thread == seen["thread"] != by["root"].thread


def test_nothing_under_a_timer_opened_while_inactive():
    """A timer opened before tracing turned on keeps its children out of
    the record, so no recorded span lacks its parent."""
    with trace.timer("outer"):
        trace.enable()
        with trace.span("inner"):
            pass
        with trace.timer("inner_timer"):
            pass
    with trace.span("after"):
        pass
    assert [sp.name for sp in trace.spans()] == ["after"]


def test_spans_are_the_profilers_annotations(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    assert not trace.active()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.active()
        with trace.span("outer", window=4):
            with trace.span("inner"):
                torch.ones(4).add_(1)
            with trace.span("inner2"):
                pass
    assert not trace.active()
    by = {sp.name: sp for sp in trace.spans()}
    assert by["inner"].parent == by["outer"].id == by["inner2"].parent
    assert by["inner"].window == by["inner2"].window == 4
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ann = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation"}
    assert {"outer", "inner", "inner2"} <= set(ann)
    o = ann["outer"]
    for name in ("inner", "inner2"):
        e = ann[name]
        assert e["tid"] == o["tid"]
        assert o["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= o["ts"] + o["dur"]


# -- the fleet stream's spans ------------------------------------------------

WINDOW_TREE = {
    "stream.window": None,
    "stream.take": "stream.window",
    "stream.turnaround": "stream.window",
    "stream.pre_window": "stream.turnaround",
    "episode.inputs": "stream.turnaround",
    "episode.launch": "stream.turnaround",
    "episode.harvest": "stream.turnaround",
    "harvest.wait": "episode.harvest",
    "harvest.logs": "episode.harvest",
    "stream.supervise": "stream.window",
    "stream.checkpoint": "stream.window",
    "ckpt.meta": "stream.checkpoint",
    "ckpt.wait": "stream.checkpoint",
    "ckpt.snapshot": "stream.checkpoint",
    "stream.offer": None,
    "ckpt.write": None,
    "ckpt.compress": "ckpt.write",
    "ckpt.data_fsync": "ckpt.write",
    "ckpt.manifest": "ckpt.write",
    "ckpt.commit": "ckpt.write",
    "ckpt.gc": "ckpt.write",
}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Two windows served with the recorder on and two with it off, from
    the same start: (logs on, spans, counters, runner, logs off)."""
    tmp = tmp_path_factory.mktemp("trace_stream")
    trace.clear()
    trace.enable()
    try:
        runner = _runner(tmp, "on")
        logs_on = _serve(runner, 2)
    finally:
        trace.enable(False)
    spans, counts = trace.spans(), trace.counts()
    trace.clear()
    logs_off = _serve(_runner(tmp, "off"), 2)
    return logs_on, spans, counts, runner, logs_off


def test_a_window_with_its_checkpoint_gives_the_span_tree(served):
    _, spans, counts, runner, _ = served
    by_id = {sp.id: sp for sp in spans}
    serving = next(sp.thread for sp in spans if sp.name == "stream.window")
    for window in (1, 2):
        got = [sp for sp in spans if sp.window == window]
        names = sorted(sp.name for sp in got)
        assert names == sorted(WINDOW_TREE), (window, names)
        for sp in got:
            parent = by_id[sp.parent].name if sp.parent is not None \
                else None
            assert parent == WINDOW_TREE[sp.name], sp
            writer = sp.name == "ckpt.write" or \
                WINDOW_TREE[sp.name] == "ckpt.write"
            assert (sp.thread != serving) == writer, sp
            assert sp.clock == "host" and sp.t0 <= sp.t1
    # the lists the driver, stats() and the tests read: the spans' clocks
    for name, xs in (("stream.turnaround", runner.window_walls),
                     ("ckpt.snapshot", runner.saver.snapshot_s),
                     ("ckpt.write", runner.saver.write_s)):
        assert [sp.seconds for sp in spans if sp.name == name] == xs, name
    # the window is its children and its own time
    for root in (sp for sp in spans if sp.name == "stream.window"):
        kids = sum(sp.seconds for sp in spans if sp.parent == root.id)
        assert kids <= root.seconds
    assert counts["ckpt.bytes"] > 0


def test_logs_are_bitwise_the_same_with_tracing_on_and_off(served):
    logs_on, _, _, _, logs_off = served
    assert len(logs_on["W"]) == 2 * WINDOW
    for k in LOG_KEYS:
        np.testing.assert_array_equal(logs_on[k], logs_off[k], err_msg=k)


def test_a_restore_is_a_span_and_a_time(tmp_path):
    r = _runner(tmp_path, "ck")
    _serve(r, 1)
    trace.enable()
    r2 = _runner(tmp_path, "ck")
    assert r2.restore()
    r2.close()
    rs = [sp for sp in trace.spans() if sp.name == "stream.restore"]
    assert [sp.seconds for sp in rs] == r2.restore_s


def test_the_launchers_trace_flag_prints_each_span(capsys, tmp_path):
    from repro_torch.launch import serve as t_serve
    t_serve.main(["--fleet-stream", "--device", "cpu", "--num-cameras",
                  str(C), "--stream-slots", "4", "--window-slots", "2",
                  "--ckpt-dir", str(tmp_path / "ck"), "--trace"])
    trace.enable(False)
    out = capsys.readouterr().out
    rows = {line.split()[2]: line for line in out.splitlines()
            if line.startswith(("# span ", "# count "))}
    assert {"stream.window", "stream.turnaround", "episode.launch",
            "harvest.wait", "ckpt.write", "ckpt.bytes"} <= set(rows)
    assert "'n': 2" in rows["stream.window"]
    assert "p95_ms" in rows["stream.window"]
    assert int(rows["ckpt.bytes"].split()[3]) > 0


@pytest.mark.parametrize("num_cameras", [5, 16])
def test_the_launchers_pin_covers_its_soak_stream(num_cameras):
    """The launcher's pinned capacity covers every window of its default
    soak stream (64 slots, windows of 8) with the elastic borrow, where
    the 5-camera pin of 8000 Kbps refuses the 16-camera stream, and its
    system and runner build at that width."""
    from repro_torch.core import allocation
    from repro_torch.launch import serve as t_serve
    cfg = t_serve.fleet_system_config(num_cameras)
    assert cfg.scene.num_cameras == num_cameras and cfg.episode
    bitrates = cfg.codec.bitrates_kbps
    borrow = cfg.elastic.budget_kbits / cfg.codec.slot_seconds
    trace_kbps, live = make_soak_stream(64, num_cams=num_cameras)
    refused = 0
    for w in range(0, len(trace_kbps), 8):
        kw = dict(elastic_borrow_kbps=borrow)
        allocation.trace_capacity(bitrates, trace_kbps[w:w + 8],
                                  num_cameras, pin_kbps=cfg.w_cap_kbps, **kw)
        try:
            allocation.trace_capacity(bitrates, trace_kbps[w:w + 8],
                                      num_cameras, pin_kbps=8000.0, **kw)
        except ValueError:
            refused += 1
    assert (refused > 0) == (num_cameras > 5)
    s = t_sched.DeepStreamSystem(cfg, load_detector("light", "cpu"),
                                 load_detector("server", "cpu"),
                                 device="cpu")
    r = StreamingFleetRunner(s, DeviceScene(cfg.scene, device="cpu"),
                             cfg=StreamConfig(window_slots=8))
    assert r.offer(trace_kbps[:8], faults=live[:8]) == 8
    r.close()


# -- stage marks -------------------------------------------------------------

def _slot_inputs(device, num_cameras=C):
    s = _system(device, num_cameras)
    scene = DeviceScene(s.cfg.scene, device=device)
    trace_kbps, live = _stream(WINDOW, num_cameras)
    kw = s._episode_kwargs(scene, trace_kbps, "deepstream", faults=live)
    return t_fleet.episode_inputs("deepstream", **kw)


def test_slot_front_marks_its_stage_boundaries_and_changes_nothing():
    inp = _slot_inputs("cpu")
    slot = tuple(x[0] for x in inp.xs)
    plain = t_fleet.slot_front(inp.statics, inp.ctx, inp.carry, *slot)
    marks = []
    marked = t_fleet.slot_front(inp.statics, inp.ctx, inp.carry, *slot,
                                mark=marks.append)
    assert marks == [0, 1, 2, 3, 4]
    assert len(t_fleet.MARKS) == t_fleet.MARK_COLS == 9
    assert t_fleet.STAMP_COLS == t_fleet.OVERFLOW_COL + 1 == 10
    a, b = t_fleet._leaves(plain), t_fleet._leaves(marked)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_stamps_on_the_cpu_and_on_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    stamps = torch.zeros((3, t_fleet.MARK_COLS), dtype=torch.int64)
    counter = torch.tensor(1, dtype=torch.int64)
    for k in range(t_fleet.MARK_COLS):
        stamp_ops.stamp(stamps, counter, k)
    row = stamps[1].numpy()
    assert (row > 0).all() and (np.diff(row) >= 0).all()
    assert (stamps[0] == 0).all() and (stamps[2] == 0).all()
    with pytest.raises(ValueError, match="columns"):
        stamp_ops.stamp(stamps, counter, t_fleet.MARK_COLS)
    # the dry run's stand-in: nothing written, no launch recorded
    calls = []
    saved = t_device.KERNEL_RECORDER
    t_device.KERNEL_RECORDER = lambda *a: calls.append(a)
    try:
        with FakeTensorMode():
            fs = torch.zeros((3, t_fleet.MARK_COLS), dtype=torch.int64)
            fc = torch.zeros((), dtype=torch.int64)
            assert stamp_ops.stamp(fs, fc, 0) is None
    finally:
        t_device.KERNEL_RECORDER = saved
    assert calls == []


def test_record_stages_maps_rows_to_slots():
    T, t0 = 3, 40
    stamps = np.zeros((T + 1, t_fleet.STAMP_COLS), np.int64)
    for i in range(T + 1):
        # marks 0-8 (the finish's in the order 5, 7, 8, 6), then the
        # row's overflow count
        stamps[i] = np.array([0, 10, 30, 60, 100, 0, 7, 4, 6, 0]) + (
            1_000_000 * i * (np.arange(t_fleet.STAMP_COLS)
                             < t_fleet.MARK_COLS))
        stamps[i, t_fleet.OVERFLOW_COL] = i
    trace.enable()
    for pipelined in (True, False):
        trace.clear()
        t_fleet.record_stages(stamps, T, t0, pipelined)
        spans = trace.spans()
        assert len(spans) == T * len(t_fleet.STAGES)
        assert {sp.ids["slot"] for sp in spans} == {40, 41, 42}
        assert all(sp.clock == "device" for sp in spans)
        got = {sp.name: round(sp.seconds * 1e9) for sp in spans
               if sp.ids["slot"] == 41}
        assert got == {"stage.synth": 10, "stage.roidet": 20,
                       "stage.control": 30, "stage.encode": 40,
                       "stage.finish": 7, "stage.detect": 4,
                       "stage.decode": 2}
        # the overflow of each slot's finish row, on its decode span and
        # summed in the counter
        rows = [1, 2, 3] if pipelined else [0, 1, 2]
        assert [sp.ids["overflow_frames"] for sp in spans
                if sp.name == "stage.decode"] == rows
        assert trace.counts()["nms.overflow_frames"] == sum(rows)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the stage marks are a CUDA kernel)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_the_stamp_kernel_reads_the_cards_timer(card):
    stamps = torch.zeros((2, t_fleet.MARK_COLS), dtype=torch.int64,
                         device=card)
    counter = torch.ones((), dtype=torch.int64, device=card)
    stamp_ops.stamp(stamps, counter, 0)
    torch.cuda._sleep(2_000_000)
    stamp_ops.stamp(stamps, counter, 1)
    got = stamps.cpu().numpy()
    assert (got[0] == 0).all() and (got[1, 2:] == 0).all()
    assert got[1, 1] - got[1, 0] > 10_000     # the sleep, in ns


def _episode_logs(device, eager, num_cameras=5):
    s = _system(device, num_cameras)
    scene = DeviceScene(s.cfg.scene, device=device)
    trace_kbps, live = _stream(8, num_cameras)
    out = s._episode_dispatch(scene, trace_kbps, "deepstream", faults=live,
                              _eager=eager)
    return out, s._episode_logs(out, trace_kbps)


@pytest.mark.cuda
@pytest.mark.parametrize("tracing", [False, True])
def test_graphed_episode_with_marks_equals_the_eager_body(card, tracing):
    trace.enable(tracing)
    _, eager = _episode_logs(card, True)
    out, graphed = _episode_logs(card, False)
    for k in eager:
        np.testing.assert_array_equal(graphed[k], eager[k], err_msg=k)
    assert (out.stamps is not None) == tracing


@pytest.mark.cuda
def test_marks_are_monotone_within_each_slot(card):
    trace.enable()
    fetched = t_sched.d2h_fetch_counts()["stamps"]
    out, logs = _episode_logs(card, False)
    assert t_sched.d2h_fetch_counts()["stamps"] == fetched + 1
    T = len(logs["W"])
    st = out.stamps.cpu().numpy()
    assert st.shape == (T + 1, t_fleet.STAMP_COLS)
    for i in range(T):
        front = st[i, :5]
        # pipelined: the next row's, in the order they are taken
        finish = st[i + 1, [5, 7, 8, 6]]
        assert (front > 0).all() and (np.diff(front) >= 0).all(), (i, front)
        assert 0 < finish[0] and (np.diff(finish) >= 0).all(), (i, finish)
        assert st[i + 1, t_fleet.OVERFLOW_COL] == 0      # conv4: no cap
        # the finish starts after the slot's front has staged it
        assert finish[0] >= front[4], i
    stages = [sp for sp in trace.spans() if sp.clock == "device"]
    assert len(stages) == T * len(t_fleet.STAGES)
    assert all(sp.seconds >= 0.0 for sp in stages)


@pytest.mark.cuda
def test_tracing_captures_no_new_graph(card):
    _episode_logs(card, False)
    n = t_fleet.episode_graph_count()
    trace.enable()
    _episode_logs(card, False)
    trace.enable(False)
    _episode_logs(card, False)
    assert t_fleet.episode_graph_count() == n
