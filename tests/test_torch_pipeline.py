"""The port's production episode on the CPU: the pipelined body against
the reference body and bucketed against unbucketed (bitwise), a chain of
carried windows against one run, a dead camera against a fleet without
it, ``bucket_len`` and the labeler against the JAX package's, and no host
read anywhere in an episode's dispatch (the CPU counterpart of running it
under ``torch.cuda.set_sync_debug_mode("error")`` on the card).  With a
card, the cc_label kernel against its plain version and the replayed
graph against the eager loop."""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

import harness  # noqa: E402
from repro.core import cc as j_cc  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core import cc as t_cc  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core.scheduler import (METHODS, DeepStreamSystem,  # noqa
                                        SystemConfig)
from repro_torch.core.utility import init_utility_mlp  # noqa: E402
from repro_torch.data.scenarios import make_faults, make_trace  # noqa
from repro_torch.data.synthetic import (DeviceScene,  # noqa: E402
                                        DeviceSceneParams, SceneConfig)
from repro_torch.kernels.cc_label import ops as cc_ops  # noqa: E402
from repro_torch.kernels.cc_label import ref as cc_ref  # noqa: E402
from repro_torch.kernels.edge_motion import ops as em_ops  # noqa: E402
from repro_torch.kernels.knapsack_dp import ops as dp_ops  # noqa: E402
from repro_torch.kernels.tx_codec import ops as tx_ops  # noqa: E402
from repro_torch.models.detector import load_detector  # noqa: E402

C = 3
SCENE = SceneConfig(seed=33, num_cameras=C)
LOG_KEYS = ("utility", "mean_f1", "bytes", "W", "extra", "alloc_kbps",
            "area")


@pytest.fixture(scope="module")
def weights():
    return load_detector("light", "cpu"), load_detector("server", "cpu")


def _system(weights, num_cams=C, device="cpu", **kw) -> DeepStreamSystem:
    """The harness's fixed artifacts (untrained MLP, linspace jcab table,
    pinned DP capacity) on a port system."""
    cfg = SystemConfig(scene=dataclasses.replace(SCENE, num_cameras=num_cams),
                       eval_frames=3, w_cap_kbps=harness.W_CAP_KBPS, **kw)
    s = DeepStreamSystem(cfg, *weights, device=device)
    s.mlp = init_utility_mlp(prng.PRNGKey(0, device=s.device))
    s.tau_wl, s.tau_wh = 300.0, 2500.0
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    return s


def _scene(num_cams=C) -> DeviceScene:
    return DeviceScene(dataclasses.replace(SCENE, num_cameras=num_cams),
                       device="cpu")


def _trace(T, family="step_drop", seed=2):
    return make_trace(family, T, seed=seed, num_cams=C)


def _same_carry(a, b) -> None:
    for x, y in zip(a.est, b.est):
        assert torch.equal(x, y)
    assert torch.equal(a.ref, b.ref)
    np.testing.assert_array_equal(a.live_prev, b.live_prev)
    assert a.t_first == b.t_first


# -- bucket_len -----------------------------------------------------------

def test_bucket_len_matches_jax():
    for buckets in (t_fleet.EPISODE_BUCKETS, None, (), (4,), (3, 10),
                    (16, 8), (1,)):
        for T in (1, 2, 3, 5, 7, 8, 9, 11, 16, 17, 31, 32, 33, 64, 65, 100):
            assert t_fleet.bucket_len(T, buckets) == \
                j_fleet.bucket_len(T, buckets), (T, buckets)
    assert t_fleet.EPISODE_BUCKETS == j_fleet.EPISODE_BUCKETS
    for bad in ((0,), (8, -1)):
        with pytest.raises(ValueError, match=">= 1"):
            t_fleet.bucket_len(5, bad)


def test_config_fields():
    cfg = SystemConfig()
    assert cfg.episode_pipelined is True
    assert cfg.episode_buckets == t_fleet.EPISODE_BUCKETS
    assert "deepstream_no_elastic" in METHODS


# -- the pipelined body, the buckets and the carry ------------------------

@pytest.mark.parametrize("method", METHODS)
def test_pipelined_equals_reference_bitwise(weights, method):
    """Cameras leave and rejoin, so the pipelined body compacts and
    restores camera rows; every log and the final carry equal the
    reference body's bit for bit."""
    T = 5
    faults = make_faults("camera_churn", T, C, seed=4)
    assert not faults.all()
    runs = {}
    for pipelined in (True, False):
        s = _system(weights, episode_pipelined=pipelined)
        logs = s.run_episode(_scene(), _trace(T), method, faults=faults)
        runs[pipelined] = (logs, s.last_carry)
    for k in LOG_KEYS:
        np.testing.assert_array_equal(runs[True][0][k], runs[False][0][k],
                                      err_msg=f"{method} {k}")
    _same_carry(runs[True][1], runs[False][1])


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_buckets_equal_unbucketed_bitwise(weights, method, pipelined):
    """T = 5 padded to the bucket of 8 against no padding: the same logs
    and the same carry, bit for bit."""
    T = 5
    faults = make_faults("camera_flap", T, C, seed=1)
    runs = []
    for buckets in (t_fleet.EPISODE_BUCKETS, None):
        s = _system(weights, episode_pipelined=pipelined,
                    episode_buckets=buckets)
        logs = s.run_episode(_scene(), _trace(T), method, faults=faults)
        runs.append((logs, s.last_carry))
    assert t_fleet.bucket_len(T) == 8
    for k in LOG_KEYS:
        np.testing.assert_array_equal(runs[0][0][k], runs[1][0][k])
    _same_carry(runs[0][1], runs[1][1])


def _window(s, runner, scene, trace, method, faults, carry):
    if runner == "episode":
        return s.run_episode(scene, trace, method, faults=faults,
                             carry=carry)
    return s._run_batched(scene, trace, method, method == "deepstream",
                          faults=faults, carry=carry)


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
@pytest.mark.parametrize("runners", [("episode", "episode"), ("run", "run"),
                                     ("episode", "run")])
def test_carried_windows_equal_one_run(weights, method, runners):
    """Windows of 3 and 4 slots on one scene, the second seeded with the
    first's ``last_carry``, against one 7-slot episode: <= 1e-5 (the JAX
    package's windowed-serving rule).  Each window's carry is recorded."""
    T = 7
    trace = _trace(T)
    faults = make_faults("camera_churn", T, C, seed=6)
    s = _system(weights)
    want = s.run_episode(_scene(), trace, method, faults=faults)
    whole = s.last_carry
    scene = _scene()
    parts, carry = [], None
    for runner, sl in zip(runners, (slice(0, 3), slice(3, T))):
        parts.append(_window(s, runner, scene, trace[sl], method,
                             faults[sl], carry))
        carry = s.last_carry
        np.testing.assert_array_equal(carry.live_prev, faults[sl.stop - 1])
        assert carry.t_first == 0
    got = {k: np.concatenate([p[k] for p in parts]) for k in LOG_KEYS}
    harness.assert_logs_match(want, got, ctx=f"{runners} {method}")
    for x, y in zip(whole.est, carry.est):
        np.testing.assert_allclose(y.numpy(), x.numpy(), atol=1e-5)
    np.testing.assert_array_equal(whole.ref.numpy(), carry.ref.numpy())


def _paired_scenes():
    """A C-camera scene and the (C-1)-camera scene holding exactly its
    first C-1 cameras (params row-sliced, same key)."""
    full, absent = _scene(C), _scene(C - 1)
    p = full.params
    absent.params = DeviceSceneParams(
        p.backgrounds[:C - 1], p.stat_boxes[:C - 1], p.stat_valid[:C - 1],
        p.offsets[:C - 1], p.lags[:C - 1], p.cam_ids[:C - 1], p.objects)
    absent.key = full.key
    return full, absent


@pytest.mark.parametrize("method,runner", [(m, "episode") for m in METHODS]
                         + [("deepstream", "run"), ("reducto", "run")])
def test_dead_camera_equals_absent(weights, method, runner):
    T = 4
    trace = _trace(T, "fcc_medium", 8)
    faults = np.ones((T, C), bool)
    faults[:, C - 1] = False
    full, absent = _paired_scenes()
    run = "run_episode" if runner == "episode" else "run"
    got = getattr(_system(weights), run)(full, trace, method, faults=faults)
    want = getattr(_system(weights, C - 1), run)(absent, trace, method)
    harness.assert_logs_match(want, got, ctx=f"dead!=absent {runner} "
                                             f"{method}")


# -- the labeler ------------------------------------------------------------

def serpentine(M: int, N: int) -> np.ndarray:
    """One one-cell-wide path through every other row, joined at
    alternating ends: the labels need close to M*N/2 passes."""
    m = np.zeros((M, N), bool)
    m[::2] = True
    for r in range(1, M, 2):
        m[r, N - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def label_cases(M: int, N: int) -> np.ndarray:
    rng = np.random.default_rng(M * N)
    masks = [rng.uniform(size=(M, N)) < p for p in (0.1, 0.3, 0.45, 0.6)]
    masks += [serpentine(M, N), np.zeros((M, N), bool),
              np.ones((M, N), bool)]
    return np.stack(masks)


@pytest.mark.parametrize("M,N", [(12, 20), (68, 120), (1, 7), (9, 1)])
def test_plain_labeler_matches_jax(M, N):
    """``cc_label``'s plain version and the boxes built on it against
    ``repro.core.cc.label_and_boxes``: labels, boxes and valid flags
    bitwise, on random masks, the serpentine, empty and full masks."""
    m = label_cases(M, N)
    fn = jax.jit(jax.vmap(functools.partial(j_cc.label_and_boxes,
                                            max_boxes=16)))
    bj, vj, lj = fn(jnp.asarray(m))
    np.testing.assert_array_equal(
        cc_ref.cc_label_ref(torch.from_numpy(m)).numpy(), np.asarray(lj))
    bt, vt, lt = t_cc.label_and_boxes(torch.from_numpy(m), max_boxes=16)
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())


def test_serpentine_needs_many_passes():
    m = torch.from_numpy(serpentine(12, 20))[None]
    labels = torch.where(m, torch.arange(240, dtype=torch.int32).reshape(
        1, 12, 20), cc_ref.INF)
    passes = 0
    while True:
        nxt = cc_ref._propagate(labels, m)
        if torch.equal(nxt, labels):
            break
        labels, passes = nxt, passes + 1
    assert passes >= 12 * 20 // 2 - 10
    assert torch.equal(labels, cc_ref.cc_label_ref(m))


def test_labeler_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        cc_ops.cc_label_cuda(torch.zeros((1, 4, 4), dtype=torch.bool))


# -- no host read in an episode's dispatch ----------------------------------

class HostRead(AssertionError):
    pass


class NoHostReads(TorchFunctionMode):
    """Raises on every call that reads a device tensor from the host or
    sends host data up inside the region: what would make the card wait
    (``set_sync_debug_mode("error")``) or break a graph capture.  Inside
    ``opaque`` (a kernel's plain version, which on the card is one launch)
    nothing is checked."""

    READS = {torch.Tensor.item, torch.Tensor.__bool__, torch.Tensor.tolist,
             torch.Tensor.numpy, torch.Tensor.cpu, torch.Tensor.__int__,
             torch.Tensor.__float__, torch.Tensor.__index__, torch.equal,
             torch.nonzero, torch.Tensor.nonzero, torch.masked_select,
             torch.unique, torch.Tensor.unique}

    def __init__(self):
        super().__init__()
        self.depth = 0

    def opaque(self, fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            self.depth += 1
            try:
                return fn(*a, **kw)
            finally:
                self.depth -= 1
        return run

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.depth == 0:
            self._check(func, args)
        return func(*args, **kwargs)

    def _check(self, func, args) -> None:
        if func in self.READS:
            raise HostRead(f"host read: {func.__name__}")
        if func in (torch.tensor, torch.as_tensor) and not \
                torch.is_tensor(args[0]):
            raise HostRead(f"upload: {func.__name__} of host data")
        if func is torch.where and len(args) == 1:
            raise HostRead("torch.where(cond) reads the device")
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(torch.is_tensor(i) and i.dtype == torch.bool
                   and i.dim() > 0 for i in idx):
                raise HostRead("boolean-mask indexing reads the device")


@pytest.fixture
def guard(monkeypatch):
    """The mode, with each kernel's plain version marked opaque (on the
    card each is one launch that reads its operands where they lie)."""
    mode = NoHostReads()
    for mod, name in ((cc_ops.ref, "cc_label_ref"),
                      (tx_ops.ref, "tx_codec_ref"),
                      (em_ops.ref, "segment_motion_ref"),
                      (dp_ops.ref, "knapsack_dp_ref"),
                      (dp_ops.ref, "backtrack_device")):
        monkeypatch.setattr(mod, name, mode.opaque(getattr(mod, name)))
    return mode


@pytest.mark.parametrize("method", METHODS)
def test_episode_dispatch_reads_nothing_from_the_device(weights, guard,
                                                       method):
    """Everything of ``run_episode`` before its harvest (the uploads, the
    slots of the pipelined body under churn, the carry) issues no host
    read; the harvest after it is the one fetch."""
    T = 3
    s = _system(weights)
    scene = _scene()
    faults = make_faults("camera_churn", T, C, seed=4)
    with guard:
        out = s._episode_dispatch(scene, _trace(T), method, faults=faults)
    logs = s._episode_logs(out, _trace(T))
    assert np.all(np.isfinite(logs["utility"]))


def test_guard_catches_the_plain_labeler_loop(weights, guard):
    """The plain labeler's early exit reads a flag on the host: the guard
    catches it alone and inside a deepstream slot when it is not behind
    the kernel's dispatcher."""
    m = torch.from_numpy(label_cases(12, 20))
    with pytest.raises(HostRead, match="equal"):
        with guard:
            cc_ref.cc_label_ref.__wrapped__(m)
    s, scene = _system(weights), _scene()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cc_ops, "cc_label", cc_ref.cc_label_ref.__wrapped__)
        with pytest.raises(HostRead, match="equal"):
            with guard:
                s._episode_dispatch(scene, _trace(2), "deepstream")


def test_guard_catches_a_per_slot_upload(weights, guard):
    """A slot index read back to the host (the old ``int(t)``) trips the
    guard."""
    key = prng.PRNGKey(1)
    with pytest.raises(HostRead, match="__int__"):
        with guard:
            prng.fold_in(key, int(torch.arange(3)[1]))
    with guard:
        prng.fold_in(key, torch.arange(3)[1])


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(12, 20), (68, 120)])
def test_cc_label_cuda_matches_plain(cuda, M, N):
    m = torch.from_numpy(label_cases(M, N)).to(cuda)
    got = cc_ops.cc_label_cuda(m)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cc_ref.cc_label_ref(m.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_graph_replay_matches_eager(cuda, weights, method):
    """The replayed pipelined graph against the eager reference body on
    the card, bitwise; a second run captures nothing new."""
    s = _system(weights, device=cuda)
    trace = _trace(5)
    faults = make_faults("camera_churn", 5, C, seed=4)
    scene = lambda: DeviceScene(SCENE, device=cuda)
    got = s.run_episode(scene(), trace, method, faults=faults)
    n = t_fleet.episode_graph_count()
    again = s.run_episode(scene(), trace, method, faults=faults)
    assert t_fleet.episode_graph_count() == n
    ref = _system(weights, device=cuda, episode_pipelined=False)
    want = ref._episode_logs(ref._episode_dispatch(
        scene(), trace, method, faults=faults, _eager=True), trace)
    for k in LOG_KEYS:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(again[k], want[k])
