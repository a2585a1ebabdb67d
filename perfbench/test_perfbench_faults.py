"""Each fault the fleet stream cells can have, planted under a run of the
harness on the CPU (the look for a card skipped, everything else as a run
does it), turns ``correct`` false: a step that hands its state back
unchanged, half the cameras left out with the mean over the rest, and an
answer altered where it is produced.  (One card: no exchange between
chips to leave out.)"""
import numpy as np
import pytest
import torch

from perfbench.conftest import TINY_SEED
from perfbench.core import bench
from perfbench.drivers import fleet_stream as fs

torch.set_num_threads(1)


def _state_unchanged(monkeypatch):
    """The stream's carried state, its slot cursor, handed back as it was:
    every window serves the stream's first slots again."""
    from repro_torch.core.scheduler import DeepStreamSystem
    orig = DeepStreamSystem._episode_dispatch

    def dispatch(self, scene, trace_kbps, *a, **k):
        out = orig(self, scene, trace_kbps, *a, **k)
        scene._t -= len(trace_kbps)
        return out
    monkeypatch.setattr(DeepStreamSystem, "_episode_dispatch", dispatch)


def _half_the_cameras(monkeypatch):
    """Logs over the first half of the cameras, the mean over those."""
    from repro_torch.core.scheduler import DeepStreamSystem
    orig = DeepStreamSystem._episode_logs

    def logs(self, out, trace_kbps):
        got = orig(self, out, trace_kbps)
        p = out.packs.cpu().numpy()
        h = max(1, p.shape[2] // 2)
        got.update(utility=p[:, 0, :h].sum(axis=1),
                   mean_f1=p[:, 0, :h].mean(axis=1),
                   bytes=p[:, 1, :h].sum(axis=1))
        return got
    monkeypatch.setattr(DeepStreamSystem, "_episode_logs", logs)


def _answer_altered(monkeypatch):
    """Camera 0's F1 altered where the slot's finish produces it."""
    from repro_torch.core import fleet
    orig = fleet._finish

    def finish(*a, **k):
        pack = orig(*a, **k).clone()
        pack[0, 0] = pack[0, 0] + 0.25
        return pack
    monkeypatch.setattr(fleet, "_finish", finish)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_cameras,
                                   _answer_altered])
def test_a_planted_fault_turns_correct_false(fault, monkeypatch, tiny_cell):
    fault(monkeypatch)
    out = fs.run(tiny_cell, TINY_SEED, 0.0, False, "cpu", 0.0,
                 max_windows=2)
    line = bench.result_line(out, {}, False)
    assert line["correct"] is False
    gap = line["check"]["log_gap"]
    assert gap["value"] > gap["limit"]


def test_the_unbroken_run_is_correct(tiny_cell):
    out = fs.run(tiny_cell, TINY_SEED, 0.0, True, "cpu", 0.0,
                 max_windows=2)
    line = bench.result_line(out, {}, False)
    assert line["correct"] is True, line["check"]
    assert line["check"]["log_gap"]["value"] == 0.0
    # 1 measured, then 1 recorded and 1 profiled
    assert out.attempted == 3 and out.failed == 0
    rd = out.readings
    assert rd.counters["degraded_windows"] == 0
    assert rd.counters["graph_captures_in_window"] == 0
    assert rd.counters["camera_slots"] == 2 * 2
    assert np.isfinite(rd.durations("serve_window")).all()
