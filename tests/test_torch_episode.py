"""Headline parity: the port's whole-trace episode against the JAX
package's, for every method and under camera churn, plus the port's
isolation from JAX and its device guard."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

import harness  # noqa: E402
from repro.data.scenarios import make_faults, make_scene, make_trace  # noqa
from repro.data.synthetic import DeviceScene as JDeviceScene  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig  # noqa
from repro_torch.core.utility import init_utility_mlp  # noqa: E402
from repro_torch.data.synthetic import DeviceScene, SceneConfig  # noqa: E402
from repro_torch.models.detector import load_detector  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCENE = ("urban_mid", 33)
T_SLOTS = 4
METHODS = harness.METHODS + ("deepstream_no_elastic",)


def _port_system(scene_cfg) -> DeepStreamSystem:
    """The harness's fixed artifacts, built by the port itself."""
    cfg = SystemConfig(scene=SceneConfig(**dataclasses.asdict(scene_cfg)),
                       eval_frames=3, w_cap_kbps=harness.W_CAP_KBPS)
    s = DeepStreamSystem(cfg, load_detector("light", "cpu"),
                         load_detector("server", "cpu"), device="cpu")
    s.mlp = init_utility_mlp(prng.PRNGKey(0))
    s.tau_wl, s.tau_wh = 10.0, 50.0
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    return s


@pytest.fixture(scope="module")
def systems(detectors):
    scene_cfg = make_scene(*SCENE)
    return (harness.build_system(detectors, "episode", scene_cfg),
            _port_system(scene_cfg))


def _run_pair(systems, method, trace, faults=None):
    js, ts = systems
    js._key = jax.random.PRNGKey(1234)
    want = js.run(JDeviceScene(js.cfg.scene), trace, method=method,
                  faults=faults)
    got = ts.run_episode(DeviceScene(ts.cfg.scene, device="cpu"), trace,
                         method, faults=faults)
    return want, got


@pytest.mark.parametrize("method", METHODS)
def test_episode_matches_jax(systems, method):
    """The port's default episode (pipelined, bucketed): utility / bytes /
    alloc_kbps / extra / area equal the JAX default episode's to <= 1e-5
    (the harness's reference-relative rule)."""
    trace = make_trace("fcc_medium", T_SLOTS, seed=8, num_cams=3)
    want, got = _run_pair(systems, method, trace)
    harness.assert_logs_match(want, got, ctx=method)
    assert np.all(got["mean_f1"] >= 0) and np.all(got["mean_f1"] <= 1)


@pytest.mark.parametrize("method", METHODS)
def test_episode_camera_churn_matches_jax(systems, method):
    """Cameras leave and rejoin: dead cameras send nothing, rejoining ones
    reset the reducto reference and the elastic debt."""
    T = 6
    trace = make_trace("step_drop", T, seed=2, num_cams=3)
    faults = make_faults("camera_churn", T, 3, seed=4)
    assert not faults.all()
    want, got = _run_pair(systems, method, trace, faults=faults)
    harness.assert_logs_match(want, got, ctx=f"churn {method}")


@pytest.mark.parametrize("method", METHODS)
def test_episode_dead_camera_matches_jax(systems, method):
    """The last camera dead for the whole trace."""
    T = 5
    trace = make_trace("fcc_medium", T, seed=5, num_cams=3)
    faults = make_faults("dead_camera", T, 3, seed=0)
    want, got = _run_pair(systems, method, trace, faults=faults)
    harness.assert_logs_match(want, got, ctx=f"dead camera {method}")


def test_port_imports_no_jax():
    """Every repro_torch module imports with neither jax nor repro loaded."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if "
        "m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_or_repro_imports_in_source():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = list((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) == 4, examples
    files += examples
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_default_to_cuda():
    """No device argument means the card; without one they raise instead
    of falling back to the CPU."""
    cfg = SystemConfig(scene=SceneConfig(num_cameras=2))
    light = load_detector("light", "cpu")
    if torch.cuda.is_available():
        s = DeepStreamSystem(cfg, light, light)
        assert s.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            DeepStreamSystem(cfg, light, light)
        with pytest.raises(RuntimeError):
            DeviceScene(cfg.scene)
    s = DeepStreamSystem(cfg, light, light, device="cpu")
    assert s.device.type == "cpu"
