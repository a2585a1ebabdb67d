"""The port's crash-safe fleet serving (``repro_torch.serve.stream``)
against live JAX runs on the CPU.

Every stream here is held to the JAX package's uninterrupted episode over
the same trace (<= 1e-5, the harness's rule): windowed serving for the
four methods, kill-and-resume through an exception and through a real
SIGTERM under ``camera_churn``, a resume across packages (JAX's runner
checkpoints, the port's restores and finishes, and the other way round),
and the SLO ladder degrading to the slot loop and climbing back.  Also:
drop accounting across a restore and the runner's input errors.  The
chaos soak, the supervisor and the checked lane are in
``test_torch_supervisor.py``."""
import dataclasses
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)

import harness  # noqa: E402
from repro.data.scenarios import make_scene  # noqa: E402
from repro.data.synthetic import DeviceScene as JDeviceScene  # noqa: E402
from repro.serve import stream as j_stream  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.core.utility import init_utility_mlp  # noqa: E402
from repro_torch.data.scenarios import make_faults, make_trace  # noqa
from repro_torch.data.synthetic import (DeviceScene,  # noqa: E402
                                        MultiCameraScene, SceneConfig)
from repro_torch.ft.watchdog import WatchdogConfig  # noqa: E402
from repro_torch.models.detector import load_detector  # noqa: E402
from repro_torch.serve.stream import (LADDER, StreamConfig,  # noqa: E402
                                      StreamingFleetRunner)

SCENE = ("urban_mid", 33)
C = 3
T_REF = 32          # the JAX references' length; tests compare prefixes
STREAM_KEYS = ("utility", "mean_f1", "bytes", "alloc_kbps", "extra", "area")


def _jscene_cfg():
    return make_scene(*SCENE)


def _scene_cfg() -> SceneConfig:
    return SceneConfig(**dataclasses.asdict(_jscene_cfg()))


@pytest.fixture(scope="module")
def weights():
    return load_detector("light", "cpu"), load_detector("server", "cpu")


def _system(weights, **kw) -> t_sched.DeepStreamSystem:
    """The JAX harness's system (episode mode unless ``episode=False``),
    built by the port: pinned capacity, untrained MLP from PRNGKey(0), tau
    10/50, linspace jcab."""
    kw.setdefault("w_cap_kbps", harness.W_CAP_KBPS)
    kw.setdefault("episode", True)
    cfg = t_sched.SystemConfig(scene=_scene_cfg(), eval_frames=3, **kw)
    s = t_sched.DeepStreamSystem(cfg, *weights, device="cpu")
    s.mlp = init_utility_mlp(prng.PRNGKey(0))
    s.tau_wl, s.tau_wh = 10.0, 50.0
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    return s


def _runner(weights, method, cfg, system_kw=None, **kw):
    s = _system(weights, **(system_kw or {}))
    return StreamingFleetRunner(s, DeviceScene(s.cfg.scene, device="cpu"),
                                method=method, cfg=cfg, **kw)


def _jrunner(detectors, method, cfg, **kw):
    s = harness.build_system(detectors, "episode", _jscene_cfg())
    s._key = jax.random.PRNGKey(1234)
    return j_stream.StreamingFleetRunner(s, JDeviceScene(_jscene_cfg()),
                                         method=method, cfg=cfg, **kw)


def _inputs(T=T_REF):
    """The first T slots of the references' stream (a trace of another
    length is another draw, so every test slices this one)."""
    trace = make_trace("fcc_medium", T_REF, seed=8, num_cams=C)
    faults = make_faults("camera_churn", T_REF, C, seed=3)
    return trace[:T], faults[:T]


_REFS = {}


def _jax_ref(detectors, method, stream=None):
    """JAX's uninterrupted episode over ``stream`` ((trace, faults); the
    references' stream by default), cached per method and stream."""
    trace, faults = _inputs() if stream is None else stream
    key = (method, trace.tobytes(), faults.tobytes())
    if key not in _REFS:
        s = harness.build_system(detectors, "episode", _jscene_cfg())
        s._key = jax.random.PRNGKey(1234)
        _REFS[key] = s.run(JDeviceScene(_jscene_cfg()), trace,
                           method=method, faults=faults)
    return _REFS[key]


def _logs(runner):
    return {k: np.asarray(v) for k, v in runner.logs.items()}


def _match(ref, runner, ctx):
    got = _logs(runner)
    n = len(got["W"])
    harness.assert_logs_match({k: v[:n] for k, v in ref.items()}, got,
                              keys=STREAM_KEYS, ctx=ctx)


# -- windowed == continuous -----------------------------------------------

@pytest.mark.parametrize("method", harness.METHODS)
def test_windowed_matches_jax_continuous(detectors, weights, method):
    """Two windows (a full one and a flushed partial one) through the
    carry equal JAX's one uninterrupted episode, cameras leaving and
    rejoining."""
    trace, faults = _inputs(5)
    r = _runner(weights, method, StreamConfig(window_slots=4))
    assert r.offer(trace, faults=faults) == 5
    assert r.serve(flush=True) == 2 and r.t_next == 5
    _match(_jax_ref(detectors, method), r, f"windowed {method}")
    assert r.stats()["windows"] == 2 and r.stats()["rung"] == "episode"


# -- kill and resume --------------------------------------------------------

class _Crash(Exception):
    pass


@pytest.mark.parametrize("method,kind", [("deepstream", "exception"),
                                         ("reducto", "sigterm")])
def test_kill_and_resume_matches_jax(detectors, weights, tmp_path, method,
                                     kind):
    """Process A dies: an exception before window 1, or a real SIGTERM
    before window 0 (the window serves, the checkpointer saves blocking
    and exits 143).  A fresh system and runner restore and are re-offered
    the stream from ``t_next``: the concatenated logs equal JAX's
    uninterrupted run, no graph is captured after the restore, and each
    resumed window makes the episode's 2 harvest fetches and no other."""
    T = 8
    trace, faults = _inputs(T)

    def hook(window, rung):
        if kind == "exception" and window == 1:
            raise _Crash("window 1")
        if kind == "sigterm" and window == 0:
            signal.raise_signal(signal.SIGTERM)

    cfg = StreamConfig(window_slots=4, ckpt_dir=str(tmp_path),
                       install_signal=kind == "sigterm")
    rA = _runner(weights, method, cfg, fault_hook=hook)
    rA.offer(trace, faults=faults)
    if kind == "exception":
        with pytest.raises(_Crash):
            rA.serve(flush=True)
        rA.saver.wait()
    else:
        with pytest.raises(SystemExit) as exc:
            rA.serve(flush=True)
        assert exc.value.code == 143
    rA.checkpointer.close()
    assert rA.window == 1 and rA.t_next == 4

    graphs = t_fleet.episode_graph_count()
    d0 = t_sched.d2h_fetch_counts()
    rB = _runner(weights, method, StreamConfig(window_slots=4,
                                               ckpt_dir=str(tmp_path)))
    assert rB.restore()
    assert rB.t_next == rB.window * 4 == rA.window * 4
    rB.offer(trace[rB.t_next:], faults=faults[rB.t_next:])
    resumed = rB.serve(flush=True)
    d1 = t_sched.d2h_fetch_counts()
    assert rB.t_next == T and t_fleet.episode_graph_count() == graphs
    assert d1["harvest"] - d0["harvest"] == 2 * resumed
    assert d1["keep"] == d0["keep"] and d1["control"] == d0["control"]
    _match(_jax_ref(detectors, method), rB, f"kill-resume {method} {kind}")
    assert any(e["kind"] == "restore" for e in rB.events)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_resume_across_packages(detectors, weights, tmp_path, direction):
    """One package's runner serves window 0 and checkpoints; the other's
    restores that checkpoint (carry, run key, counters and logs) and
    serves window 1: JAX's uninterrupted logs."""
    trace, faults = _inputs(8)
    cfg = dict(window_slots=4, ckpt_dir=str(tmp_path))
    first, second = ((_jrunner(detectors, "deepstream",
                               j_stream.StreamConfig(**cfg)),
                      lambda: _runner(weights, "deepstream",
                                      StreamConfig(**cfg)))
                     if direction == "jax_to_port" else
                     (_runner(weights, "deepstream", StreamConfig(**cfg)),
                      lambda: _jrunner(detectors, "deepstream",
                                       j_stream.StreamConfig(**cfg))))
    first.offer(trace[:4], faults=faults[:4])
    assert first.serve() == 1
    first.close()
    r = second()
    assert r.restore() and r.t_next == 4 and r.window == 1
    r.offer(trace[4:], faults=faults[4:])
    assert r.serve() == 1
    r.close()
    assert float(np.asarray(r.carry.est.debt_kbits)) >= 0.0
    _match(_jax_ref(detectors, "deepstream"), r, direction)


# -- the SLO ladder ------------------------------------------------------------

def test_ladder_degrades_and_recovers_exactly(detectors, weights):
    """Straggling walls at windows 1 and 3 take the runner down to the
    slot loop; healthy ones climb back.  ``episode_small`` runs each
    window of 2 slots as two carried chunks (buckets of 1).  Every rung
    serves the same carry chain: JAX's uninterrupted logs."""
    trace, faults = _inputs(16)
    walls = {1: 6.0, 3: 6.0}
    cfg = StreamConfig(window_slots=2, queue_slots=16, recover_after=2,
                       watchdog=WatchdogConfig(warmup_steps=1,
                                               escalate_after=1))
    r = _runner(weights, "reducto", cfg,
                system_kw=dict(episode_buckets=(1, 2, 4, 8, 16, 32)),
                wall_hook=lambda w, wall: walls.get(w, 1.0))
    assert r._small_len() == 1
    r.offer(trace, faults=faults)
    r.serve(flush=True)
    moves = [(e["kind"], e["to"], e["window"]) for e in r.events
             if e["kind"] in ("degrade", "recover")]
    # an event's window counts the windows served, the straggler included
    assert moves == [("degrade", "episode_small", 2),
                     ("degrade", "pipelined", 4),
                     ("recover", "episode_small", 6),
                     ("recover", "episode", 8)]
    rungs = [e["rung"] for e in r.events if e["kind"] == "window"]
    assert rungs == ["episode", "episode", "episode_small", "episode_small",
                     "pipelined", "pipelined", "episode_small",
                     "episode_small"]
    assert r.rung == 0 and r.stats()["rung"] == LADDER[0]
    _match(_jax_ref(detectors, "reducto"), r, "ladder")


# -- accounting and errors -------------------------------------------------------

def test_drop_accounting_survives_restore(weights, tmp_path):
    trace, faults = _inputs(6)
    cfg = StreamConfig(window_slots=4, queue_slots=4, ckpt_dir=str(tmp_path))
    r = _runner(weights, "static", cfg)
    assert r.offer(trace, faults=faults) == 4
    assert r.dropped_slots == 2
    assert any(e["kind"] == "drop" and e["slots"] == 2 for e in r.events)
    assert r.serve() == 1
    r.close()
    r2 = _runner(weights, "static", cfg)
    assert r2.restore()
    assert r2.dropped_slots == 2 and r2.window == 1
    assert len(r2.logs["W"]) == 4 and r2.restore_s
    assert r2.offer(trace[r2.t_next:], faults=faults[r2.t_next:]) == 2


def test_runner_input_errors(weights, tmp_path):
    trace, _ = _inputs(4)
    r = _runner(weights, "static", StreamConfig(window_slots=4,
                                                ckpt_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="faults mask"):
        r.offer(trace, faults=np.ones((4, 99), bool))
    for bad in (np.array([np.nan]), np.array([-1.0]), np.array([np.inf])):
        with pytest.raises(ValueError, match="finite"):
            r.offer(bad)
    assert r.queued_slots() == 0
    assert not r.restore() and r.window == 0 and r.t_next == 0
    s = _system(weights, w_cap_kbps=None)
    with pytest.raises(ValueError, match="w_cap_kbps"):
        StreamingFleetRunner(s, DeviceScene(s.cfg.scene, device="cpu"))
    s = _system(weights)
    with pytest.raises(TypeError, match="DeviceScene"):
        StreamingFleetRunner(s, MultiCameraScene(s.cfg.scene))
    s.cfg.episode = False
    with pytest.raises(ValueError, match="episode-mode"):
        StreamingFleetRunner(s, DeviceScene(s.cfg.scene, device="cpu"))
