"""The port's offline profiling path against the JAX package's, on the CPU:
the host scene (``MultiCameraScene``), GT padding and the split key chain,
AdamW and the utility-MLP fit, the offline elastic thresholds, then
``DeepStreamSystem.profile`` in both branches and ``run()`` on a host scene
with the profiled artifacts.  Every JAX side runs live (never the golden
logs); the profiling scene keeps the default 96 x 160 frames at 5 frames a
segment."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

import harness  # noqa: E402
from repro.common.config import OptimizerConfig as JOptCfg  # noqa: E402
from repro.core import elastic as j_elastic  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core import utility as j_util  # noqa: E402
from repro.core.scheduler import DeepStreamSystem as JSystem  # noqa: E402
from repro.core.scheduler import SystemConfig as JSystemConfig  # noqa: E402
from repro.data import scenarios as j_sc  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.common.config import OptimizerConfig  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.core import elastic as t_elastic  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import utility as t_util  # noqa: E402
from repro_torch.core.scheduler import DeepStreamSystem  # noqa: E402
from repro_torch.core.scheduler import SystemConfig  # noqa: E402
from repro_torch.data import scenarios as t_sc  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.models.detector import load_detector  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402

FIT_TOL = 1e-5          # fitted parameters after 120 steps
STEP_TOL = 1e-6         # one optimizer step, the schedule


def _np_tree(tree):
    return {k: np.array(v) for k, v in tree.items()}


def _max_diff(jtree, ttree) -> float:
    return max(float(np.max(np.abs(np.asarray(jtree[k])
                                   - ttree[k].cpu().numpy())))
               for k in jtree)


# -- the host scene -------------------------------------------------------

@pytest.mark.parametrize("family", j_sc.scene_families())
def test_multi_camera_scene_matches_jax(family):
    """Frames bitwise and box lists equal for 3 slots of every scene
    family; the generator's state (world objects, frame index) too."""
    jcfg = j_sc.make_scene(family, 5)
    tcfg = t_sc.make_scene(family, 5)
    js, ts = j_syn.MultiCameraScene(jcfg), t_syn.MultiCameraScene(tcfg)
    for _ in range(3):
        a, b = js.segment(), ts.segment()
        assert a["frames"].dtype == b["frames"].dtype == np.float32
        np.testing.assert_array_equal(b["frames"], a["frames"])
        assert b["boxes"] == a["boxes"] and b["t"] == a["t"]
    assert [dataclasses.asdict(o) for o in ts.objects] == \
        [dataclasses.asdict(o) for o in js.objects]
    assert ts._frame_idx == js._frame_idx


# -- GT padding and the key chain -----------------------------------------

def test_pad_gt_matches_jax():
    scene = t_syn.MultiCameraScene(t_syn.SceneConfig(num_cameras=3, seed=9))
    gts = scene.segment()["boxes"]
    idx = np.array([[0, 4, 9], [1, 1, 2], [9, 0, 5]])
    for G in (16, 24):
        for got, want in ((t_fleet.pad_gt(gts, idx, G=G),
                           j_fleet.pad_gt(gts, idx, G=G)),
                          (t_fleet.pad_gt_all(gts, 10, G=G),
                           j_fleet.pad_gt_all(gts, 10, G=G))):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    many = [[[(0, 0, 4, 4)] * 17]]
    with pytest.raises(AssertionError, match="capacity"):
        t_fleet.pad_gt(many, np.zeros((1, 1), int), G=16)


@pytest.mark.parametrize("n", [0, 1, 7, 36])
def test_key_chain_matches_splits_and_jax(n):
    key = prng.PRNGKey(1234)
    got_key, got = t_fleet._key_chain(key, n)
    assert got.shape == (n, 2)
    k = key
    for i in range(n):
        k, sub = prng.split(k)
        assert torch.equal(got[i], sub)
    assert torch.equal(got_key, k)
    jk, jsubs = j_fleet._key_chain(jax.random.PRNGKey(1234), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsubs))
    np.testing.assert_array_equal(got_key.numpy(), np.asarray(jk))


# -- AdamW, the fit, the thresholds -----------------------------------------

CFG = dict(lr=3e-3, warmup_steps=20, total_steps=120, weight_decay=1e-4,
           grad_clip=1.0)


def test_lr_schedule_matches_jax():
    jcfg, tcfg = JOptCfg(**CFG), OptimizerConfig(**CFG)
    steps = np.arange(0, 160)
    sched = jax.jit(lambda s: j_opt.lr_schedule(jcfg, s))
    want = np.array([float(sched(jnp.int32(s))) for s in steps])
    got = np.array([float(t_opt.lr_schedule(
        tcfg, torch.tensor(int(s), dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=0.0)


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_adamw_step_matches_jax(scale):
    """One step on a 2-D and a 1-D leaf from non-zero moments; grads
    scaled so that the clip is active (1.0: norm ~ 13) or not (0.01)."""
    jcfg, tcfg = JOptCfg(**CFG), OptimizerConfig(**CFG)
    r = np.random.default_rng(int(scale * 100))
    P = {"w": r.normal(0, 1, (4, 32)), "b": r.normal(0, 1, (32,))}
    G = {k: r.normal(0, scale, v.shape) for k, v in P.items()}
    M = {k: r.normal(0, 0.1, v.shape) for k, v in P.items()}
    V = {k: r.uniform(0, 0.1, v.shape) for k, v in P.items()}
    f32 = lambda d, f: {k: f(v.astype(np.float32)) for k, v in d.items()}
    step = 7
    jstate = j_opt.OptState(jnp.int32(step), f32(M, jnp.asarray),
                            f32(V, jnp.asarray))
    jp, js, jinfo = jax.jit(lambda p, g, s: j_opt.adamw_update(
        jcfg, p, g, s))(f32(P, jnp.asarray), f32(G, jnp.asarray), jstate)
    tstate = t_opt.OptState(torch.tensor(step, dtype=torch.int32),
                            f32(M, torch.from_numpy), f32(V, torch.from_numpy))
    tp, ts, tinfo = t_opt.adamw_update(tcfg, f32(P, torch.from_numpy),
                                       f32(G, torch.from_numpy), tstate)
    assert (float(jinfo["grad_norm"]) > 1.0) == (scale == 1.0)
    assert int(ts.step) == int(js.step) == step + 1
    for j, t in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        assert _max_diff(j, t) <= STEP_TOL
    np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                               rtol=STEP_TOL)
    np.testing.assert_allclose(float(tinfo["grad_norm"]),
                               float(jinfo["grad_norm"]), rtol=STEP_TOL)


def test_fit_matches_jax_from_the_same_init():
    r = np.random.default_rng(4)
    n = 108
    feats = np.stack([r.uniform(0, 0.5, n), r.uniform(0, 1, n),
                      r.choice([50, 100, 200, 400, 800, 1000], n),
                      r.choice([1.0, 0.75, 0.5], n)], axis=1)
    tgts = np.clip(0.3 + feats[:, 0] + 0.05 * np.log(feats[:, 2])
                   + r.normal(0, 0.05, n), 0, 1)
    init = j_util.init_utility_mlp(jax.random.PRNGKey(3))
    t_init = params_from_numpy(_np_tree(init), "mlp", device="cpu")
    assert _max_diff(init, t_util.init_utility_mlp(prng.PRNGKey(3))) == 0.0
    for steps, tol in ((1, STEP_TOL), (120, FIT_TOL)):
        jp, jl = j_util.fit(init, feats, tgts, steps=steps)
        tp, tl = t_util.fit(t_init, feats, tgts, steps=steps)
        assert _max_diff(jp, tp) <= tol, steps
        assert abs(tl - jl) <= tol * max(1.0, abs(jl))
    assert tl < 0.5 * float(np.mean((tgts - tgts.mean()) ** 2)) + 0.05


@pytest.mark.parametrize("kind", ["mixed", "quiet", "noisy"])
def test_offline_thresholds_match_jax(kind):
    """A mixed table (both gates met), a quiet one (no std above
    sigma_high: tau_wl falls back to the lowest bitrate) and a noisy one
    (no std under sigma_low: tau_wh falls back to the highest)."""
    r = np.random.default_rng(1)
    bitrates = np.array([50, 100, 200, 400, 800, 1000])
    S, I, J = 6, 3, 6
    base = np.linspace(0.4, 0.9, J)[None, None]
    spread = {"mixed": np.array([0.2, 0.1, 0.03, 0.005, 0.001, 0.0]),
              "quiet": np.full(J, 0.02),
              "noisy": np.full(J, 0.2)}[kind]
    acc = (base + r.normal(0, 1, (S, I, J)) * spread).astype(np.float32)
    got = t_elastic.offline_thresholds(t_elastic.ElasticConfig(), acc,
                                       bitrates)
    want = j_elastic.offline_thresholds(j_elastic.ElasticConfig(), acc,
                                        bitrates)
    assert got == want
    if kind == "quiet":
        assert got[0] == bitrates[0] * I
    if kind == "noisy":
        assert got[1] == bitrates[-1] * I


# -- profile() and run() on a host scene -------------------------------------

PROFILE_SCENE = dict(seed=42, fps=5)


def _pair(detectors, C, **kw):
    """(JAX system, port system on the CPU) over one scene config."""
    light, server = detectors
    jcfg = JSystemConfig(scene=j_syn.SceneConfig(num_cameras=C,
                                                 **PROFILE_SCENE),
                         eval_frames=3, w_cap_kbps=harness.W_CAP_KBPS, **kw)
    tcfg = SystemConfig(scene=t_syn.SceneConfig(num_cameras=C,
                                                **PROFILE_SCENE),
                        eval_frames=3, w_cap_kbps=harness.W_CAP_KBPS, **kw)
    return (JSystem(jcfg, light, server),
            DeepStreamSystem(tcfg, load_detector("light", "cpu"),
                             load_detector("server", "cpu"), device="cpu"))


def _profile_pair(detectors, C, num_slots, batched):
    js, ts = _pair(detectors, C, batched=batched)
    want = js.profile(j_syn.MultiCameraScene(js.cfg.scene),
                      num_slots=num_slots, mlp_steps=120)
    got = ts.profile(t_syn.MultiCameraScene(ts.cfg.scene),
                     num_slots=num_slots, mlp_steps=120)
    return js, ts, want, got


@pytest.fixture(scope="module")
def profiled(detectors):
    """The batched profile (C=3, two slots), run once by each package."""
    return _profile_pair(detectors, 3, 2, batched=True)


def _check_profiles(js, ts, want, got):
    assert (got["tau_wl"], got["tau_wh"], got["num_samples"]) == \
        (want["tau_wl"], want["tau_wh"], want["num_samples"])
    assert abs(got["mlp_mse"] - want["mlp_mse"]) <= FIT_TOL
    assert ts.jcab_table.shape == js.jcab_table.shape
    np.testing.assert_allclose(ts.jcab_table, js.jcab_table, rtol=0,
                               atol=1e-6)
    assert _max_diff(js.mlp, ts.mlp) <= FIT_TOL
    # the split chain advanced by the same draws
    np.testing.assert_array_equal(ts._key.numpy(), np.asarray(js._key))


def test_profile_batched_matches_jax(profiled):
    js, ts, want, got = profiled
    _check_profiles(js, ts, want, got)
    assert got["num_samples"] == 2 * 3 * 6 * 3
    assert ts.mlp["w1"].device.type == "cpu"
    # the F1 table varies (a sweep of constants would prove little)
    assert np.ptp(js.jcab_table) > 0.0


def test_profile_sequential_matches_jax(detectors):
    _check_profiles(*_profile_pair(detectors, 2, 1, batched=False))


def test_profile_rejects_device_scene(profiled):
    ts = profiled[1]
    with pytest.raises(TypeError, match="MultiCameraScene"):
        ts.profile(t_syn.DeviceScene(ts.cfg.scene, device="cpu"),
                   num_slots=1, mlp_steps=1)


def _with_artifacts(ts, js):
    """The port system holding the JAX profile's artifacts, carried
    across, so that run() is compared on the same control inputs."""
    ts.mlp = params_from_numpy(_np_tree(js.mlp), "mlp", device="cpu")
    ts.tau_wl, ts.tau_wh = js.tau_wl, js.tau_wh
    ts.jcab_table = np.array(js.jcab_table)
    return ts


def _run_pair(js, ts, method, T=3):
    trace = j_sc.make_trace("fcc_medium", T, seed=8, num_cams=3)
    js._key = jax.random.PRNGKey(1234)
    ts._key = prng.PRNGKey(1234)
    want = js.run(j_syn.MultiCameraScene(js.cfg.scene), trace, method=method)
    got = ts.run(t_syn.MultiCameraScene(ts.cfg.scene), trace, method)
    return want, got


@pytest.mark.parametrize("method", harness.METHODS)
def test_run_host_scene_pipelined_matches_jax(profiled, method):
    js, ts = profiled[:2]
    want, got = _run_pair(js, _with_artifacts(ts, js), method)
    harness.assert_logs_match(want, got, ctx=f"host scene {method}")
    assert np.all((got["mean_f1"] >= 0) & (got["mean_f1"] <= 1))


def test_run_host_scene_sequential_matches_jax(profiled, detectors):
    jp = profiled[0]
    js, ts = _pair(detectors, 3, batched=False)
    js.mlp, js.tau_wl, js.tau_wh = jp.mlp, jp.tau_wl, jp.tau_wh
    js.jcab_table = jp.jcab_table
    want, got = _run_pair(js, _with_artifacts(ts, js), "deepstream", T=2)
    harness.assert_logs_match(want, got, ctx="host scene sequential")


def test_run_episode_rejects_host_scene(profiled):
    ts = profiled[1]
    with pytest.raises(TypeError, match="DeviceScene"):
        ts.run_episode(t_syn.MultiCameraScene(ts.cfg.scene),
                       np.full(2, 1000.0))
