"""Supervised runs in the port against the JAX package on the CPU:
``EpisodeSupervisor`` and the ``checked`` diagnostics lane.

  * ``EpisodeSupervisor``: retries then the chunked rung, the exhausted
    ladder, and recovery with a scripted watchdog, event for event and log
    for log against JAX's supervisor.
  * ``SystemConfig.checked``: a checked run equals the unchecked run
    bitwise in episode and pipelined mode, and a NaN bandwidth slot raises
    the JAX package's message at the harvest."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)

import harness  # noqa: E402
from repro.core import scheduler as j_sched  # noqa: E402
from repro.data.synthetic import DeviceScene as JDeviceScene  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.data.synthetic import DeviceScene  # noqa: E402
from test_torch_stream import (_inputs, _jax_ref, _jscene_cfg,  # noqa
                               _match, _system, weights)

LOG_KEYS = ("utility", "mean_f1", "bytes", "W", "extra", "alloc_kbps",
            "area")
assert weights     # the module-scoped fixture, shared with the stream tests

# -- EpisodeSupervisor ------------------------------------------------------------

BUCKETS = (4, 8)     # a T=8 run's chunked rung runs two 4-slot chunks


def _supervisors(detectors, weights, cfg_kw, hook):
    """The same supervised system in both packages; ``hook(pkg)`` makes
    each one's fault hook."""
    js = harness.build_system(detectors, "episode", _jscene_cfg(),
                              episode_buckets=BUCKETS)
    js._key = jax.random.PRNGKey(1234)
    ts = _system(weights, episode_buckets=BUCKETS)
    return (j_sched.EpisodeSupervisor(js, j_sched.SupervisorConfig(**cfg_kw),
                                      fault_hook=hook("jax")),
            t_sched.EpisodeSupervisor(ts, t_sched.SupervisorConfig(**cfg_kw),
                                      fault_hook=hook("port")))


def _events(sup):
    """Decisions without wall times and error texts."""
    return [{k: v for k, v in e.items() if k not in ("wall_s", "error")}
            for e in sup.events]


def _run_both(sups, T, method="static"):
    trace, faults = _inputs(T)
    jsup, tsup = sups
    want = jsup.run(JDeviceScene(_jscene_cfg()), trace, method=method,
                    faults=faults)
    got = tsup.run(DeviceScene(tsup.system.cfg.scene, device="cpu"), trace,
                   method=method, faults=faults)
    return want, got


def test_supervisor_retries_then_degrades_to_chunked(detectors, weights):
    calls = {"jax": [], "port": []}

    def hook(pkg):
        def fn(attempt, mode):
            calls[pkg].append((attempt, mode))
            if mode == "episode":
                raise RuntimeError("injected dispatch failure")
        return fn
    sups = _supervisors(detectors, weights, dict(max_retries=1), hook)
    want, got = _run_both(sups, 8)
    assert calls["port"] == calls["jax"] == [
        (0, "episode"), (1, "episode"), (0, "episode_chunked")]
    assert _events(sups[1]) == _events(sups[0])
    assert [e["kind"] for e in sups[1].events] == ["retry", "retry",
                                                   "degrade", "ok"]
    assert sups[1].mode == "episode_chunked" and sups[1]._chunk_len(8) == 4
    # each chunk re-seeds the carry, as JAX's chunked rung does
    harness.assert_logs_match(want, got, ctx="supervisor chunked")


def test_supervisor_exhausted_ladder_raises(detectors, weights):
    def hook(pkg):
        def fn(attempt, mode):
            raise RuntimeError(f"down at {mode}")
        return fn
    sups = _supervisors(detectors, weights, dict(max_retries=1), hook)
    trace, faults = _inputs(4)
    for sup, scene in zip(sups, (JDeviceScene(_jscene_cfg()),
                                 DeviceScene(sups[1].system.cfg.scene,
                                             device="cpu"))):
        with pytest.raises(RuntimeError, match="every mode rung") as exc:
            sup.run(scene, trace, method="static", faults=faults)
        assert "down at pipelined" in str(exc.value.__cause__)
    assert _events(sups[1]) == _events(sups[0])
    assert sups[1].mode == "pipelined"


class _ScriptedDog:
    """Scripted verdicts and a count of rebaselines."""

    def __init__(self, verdicts):
        self.verdicts = list(verdicts)
        self.rebaselines = 0

    def record(self, step, t):
        return self.verdicts.pop(0)

    def rebaseline(self):
        self.rebaselines += 1


def test_supervisor_recovers_and_rebaselines(detectors, weights):
    sups = _supervisors(detectors, weights, dict(recover_after=2),
                        lambda pkg: None)
    dogs = []
    for sup in sups:
        sup.watchdog = _ScriptedDog(["replace", "ok", "ok", "ok"])
        dogs.append(sup.watchdog)
    for _ in range(4):
        want, got = _run_both(sups, 2)
        harness.assert_logs_match(want, got, ctx="supervisor recovery")
    assert _events(sups[1]) == _events(sups[0])
    moves = [(e["kind"], e.get("to")) for e in sups[1].events
             if e["kind"] in ("degrade", "recover")]
    assert moves == [("degrade", "episode_chunked"), ("recover", "episode")]
    assert sups[1].mode == "episode" and dogs[1].rebaselines == 2


# -- the checked lane ----------------------------------------------------------------

MODES = {"episode": {}, "pipelined": {"episode": False},
         "batched": {"episode": False, "pipeline": False, "alloc": "host"}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_checked_run_equals_unchecked(detectors, weights, mode):
    """The checked lane's flags change nothing: the checked run equals
    the unchecked one bitwise (cameras leave and rejoin), and both equal
    JAX's run.  The device-control runs make the same harvest fetches
    (the flags ride the control pack); host control fetches them once
    more per slot."""
    trace, faults = _inputs(3)
    runs = {}
    for checked in (False, True):
        s = _system(weights, checked=checked, **MODES[mode])
        d0 = t_sched.d2h_fetch_counts()["harvest"]
        runs[checked] = (s.run(DeviceScene(s.cfg.scene, device="cpu"),
                               trace, "deepstream", faults=faults),
                         t_sched.d2h_fetch_counts()["harvest"] - d0)
    for k in LOG_KEYS:
        np.testing.assert_array_equal(runs[True][0][k], runs[False][0][k],
                                      err_msg=k)
    extra = 3 if mode == "batched" else 0
    assert runs[True][1] == runs[False][1] + extra
    _match(_jax_ref(detectors, "deepstream"), _Logs(runs[True][0]),
           f"checked {mode}")


class _Logs:
    """A run's logs where ``_match`` expects a runner."""

    def __init__(self, logs):
        self.logs = logs


@pytest.mark.parametrize("mode", ["episode", "pipelined"])
def test_checked_run_raises_on_nan_bandwidth(detectors, weights, mode):
    """A NaN bandwidth slot: the port raises at the harvest with the
    message JAX's checkify raises (the episode's trace check, or the
    pipelined control step's bandwidth check)."""
    trace, _ = _inputs(3)
    trace = trace.copy()
    trace[1] = np.nan
    js = harness.build_system(detectors, mode, _jscene_cfg())
    js.cfg.checked = True
    js.cfg.__post_init__()
    js.mesh = None
    js._key = jax.random.PRNGKey(1234)
    with pytest.raises(Exception) as want:
        js.run(JDeviceScene(_jscene_cfg()), trace, method="deepstream")
    s = _system(weights, checked=True, **MODES[mode])
    with pytest.raises(t_fleet.CheckError,
                       match="(?i)finite|bandwidth") as got:
        s.run(DeviceScene(s.cfg.scene, device="cpu"), trace, "deepstream")
    assert str(want.value).startswith(str(got.value) + " ")
    assert str(got.value) == {
        "episode": "episode: non-finite bandwidth trace",
        "pipelined": "control: bandwidth sample not finite/non-negative",
    }[mode]


def test_raise_failed_program_order():
    """Run-level checks first, then slot by slot, column by column."""
    msgs = ("run", "a", "b")
    t_fleet.raise_failed(np.zeros((3, 3)), msgs, run_level=1)
    flags = np.zeros((3, 3))
    flags[2, 0] = flags[1, 2] = flags[2, 1] = 1
    with pytest.raises(t_fleet.CheckError, match="^run$"):
        t_fleet.raise_failed(flags, msgs, run_level=1)
    flags[2, 0] = 0
    with pytest.raises(t_fleet.CheckError, match="^b$"):
        t_fleet.raise_failed(flags, msgs, run_level=1)
    assert len(t_fleet.EPISODE_CHECKS) == 8
    assert t_fleet.EPISODE_CHECKS[1:7] == t_fleet.CONTROL_CHECKS
