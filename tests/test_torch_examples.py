"""The port's examples (``examples/*_torch.py``) at a small size on the
CPU: the quickstart's one slot (with and without profiling), the serving
pipeline's two tiers and the training example's run and resume."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--cameras", "3", "--profile-slots", "0"],
    ["--cameras", "2", "--profile-slots", "1", "--mlp-steps", "10"]])
def test_quickstart_on_the_cpu(argv):
    out = example("quickstart_torch").main(["--device", "cpu"] + argv)
    logs = out["logs"]
    C = int(argv[1])
    assert len(logs["utility"]) == 1 and out["features"]["a"].shape == (C,)
    for k in ("utility", "mean_f1", "bytes", "alloc_kbps"):
        assert np.all(np.isfinite(logs[k])), k
    assert 0.0 <= logs["mean_f1"][0] <= 1.0 and logs["bytes"][0] > 0
    # the wrappers count kernel launches; the CPU runs the plain versions
    assert out["launches"] == dict.fromkeys(
        ("edge_motion", "cc_label", "knapsack_dp", "tx_codec"), 0)


def test_serve_pipeline_on_the_cpu():
    out = example("serve_pipeline_torch").main(
        ["--device", "cpu", "--cameras", "2", "--slots", "2",
         "--profile-slots", "1", "--mlp-steps", "10", "--requests", "4"])
    assert np.all(np.isfinite(out["logs"]["utility"]))
    assert out["stats"]["requests"] == 4
    assert all(len(r.out_tokens) == r.max_new_tokens for r in
               out["requests"])


def test_train_backbone_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_backbone_torch.py"),
         "--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "resumed from" in out.stdout and "at step 2" in out.stdout
    assert (tmp_path / "step_00000004").exists()
