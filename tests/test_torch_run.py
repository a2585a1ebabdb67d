"""The port's ``run()`` in its three runner modes against the JAX
package's ``run()`` in the same mode, on the harness's inputs (scene
``urban_mid`` seed 33, C=3, the pinned DP capacity), plus the port's own
``run()`` against its ``run_episode`` and the fetch-count contract."""
import dataclasses

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
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig  # noqa
from repro_torch.core.utility import init_utility_mlp  # noqa: E402
from repro_torch.data.synthetic import DeviceScene, SceneConfig  # noqa: E402
from repro_torch.models.detector import load_detector  # noqa: E402

SCENE = ("urban_mid", 33)
# the port's counterpart of each harness runner mode
PORT_MODES = {
    "pipelined": dict(batched=True),
    "batched": dict(batched=True, pipeline=False, alloc="host"),
    "sequential": dict(batched=False),
}


def _port_system(scene_cfg, mode) -> DeepStreamSystem:
    """The harness's fixed artifacts, built by the port itself."""
    cfg = SystemConfig(scene=SceneConfig(**dataclasses.asdict(scene_cfg)),
                       eval_frames=3, w_cap_kbps=harness.W_CAP_KBPS,
                       **PORT_MODES[mode])
    s = DeepStreamSystem(cfg, load_detector("light", "cpu"),
                         load_detector("server", "cpu"), device="cpu")
    s.mlp = init_utility_mlp(prng.PRNGKey(0))
    s.tau_wl, s.tau_wh = 10.0, 50.0
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    return s


@pytest.fixture(scope="module")
def systems(detectors):
    """mode -> (JAX system, port system), built once per mode."""
    scene_cfg = make_scene(*SCENE)
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = (harness.build_system(detectors, mode, scene_cfg),
                           _port_system(scene_cfg, mode))
        return cache[mode]
    return get


def _run_pair(pair, method, trace, faults=None):
    """(JAX logs, port logs, the port run's fetch counts by category)."""
    js, ts = pair
    js._key = jax.random.PRNGKey(1234)
    want = js.run(JDeviceScene(js.cfg.scene), trace, method=method,
                  faults=faults)
    before = t_sched.d2h_fetch_counts()
    got = ts.run(DeviceScene(ts.cfg.scene, device="cpu"), trace, method,
                 faults=faults)
    after = t_sched.d2h_fetch_counts()
    return want, got, {k: after[k] - before[k] for k in after}


def _trace(T, family="fcc_medium", seed=8):
    return make_trace(family, T, seed=seed, num_cams=3)


@pytest.mark.parametrize("method", harness.METHODS
                         + ("deepstream_no_elastic",))
def test_pipelined_run_matches_jax(systems, method):
    """Logs within the harness's 1e-5 of the JAX pipelined run.  Device
    control fetches nothing but the harvest: per slot the (2, C) log pack
    and the (4,) control pack."""
    T = 4
    want, got, fetches = _run_pair(systems("pipelined"), method, _trace(T))
    harness.assert_logs_match(want, got, ctx=f"pipelined {method}")
    assert np.all((got["mean_f1"] >= 0) & (got["mean_f1"] <= 1))
    np.testing.assert_array_equal(got["W"], want["W"])
    assert fetches == {"harvest": 2 * T, "keep": 0, "control": 0,
                       "stamps": 0}


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
def test_pipelined_camera_churn_matches_jax(systems, method):
    T = 4
    faults = make_faults("camera_churn", T, 3, seed=4)
    # camera 2 rejoins at slot 1, camera 1 leaves at slot 2
    assert not faults.all() and (faults[1:] & ~faults[:-1]).any()
    want, got, _ = _run_pair(systems("pipelined"), method,
                             _trace(T, "step_drop", 2), faults=faults)
    harness.assert_logs_match(want, got, ctx=f"churn {method}")


@pytest.mark.parametrize("method", ["deepstream", "jcab"])
def test_batched_host_alloc_matches_jax(systems, method):
    """Host control: one (2, C) harvest per slot, plus one packed (a, c)
    control fetch per slot for deepstream only."""
    T = 3
    want, got, fetches = _run_pair(systems("batched"), method, _trace(T))
    harness.assert_logs_match(want, got, ctx=f"host alloc {method}")
    assert fetches == {"harvest": T, "keep": 0,
                       "control": T if method == "deepstream" else 0,
                       "stamps": 0}


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
def test_sequential_run_matches_jax(systems, method):
    T = 2
    want, got, fetches = _run_pair(systems("sequential"), method, _trace(T))
    harness.assert_logs_match(want, got, ctx=f"sequential {method}")
    C = 3
    assert fetches == {
        "harvest": 0, "keep": C * T if method == "reducto" else 0,
        "control": T if method == "deepstream" else 0, "stamps": 0}


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
def test_run_matches_own_episode(systems, method):
    """The port's pipelined loop and its whole-trace episode are one
    computation slot for slot (the methods with state across slots)."""
    ts = systems("pipelined")[1]
    trace = _trace(3, seed=3)
    got = ts.run(DeviceScene(ts.cfg.scene, device="cpu"), trace, method)
    want = ts.run_episode(DeviceScene(ts.cfg.scene, device="cpu"), trace,
                          method)
    harness.assert_logs_match(want, got, ctx=f"run vs episode {method}")


def test_config_validation():
    with pytest.raises(ValueError):
        SystemConfig(alloc="nowhere")
    with pytest.raises(ValueError):
        SystemConfig(episode=True, batched=False)
    with pytest.raises(ValueError):
        SystemConfig(episode=True, alloc="host")
    assert SystemConfig(batched=False).alloc == "host"
