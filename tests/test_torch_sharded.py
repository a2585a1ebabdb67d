"""The port's camera-sharded fleet on the CPU against the unsharded port
and the JAX package.

Worlds of gloo ranks are spawned with ``torch.multiprocessing`` (the rank
bodies are ``tests/_torch_sharded_worker.py``): 4 ranks run C=5 padded to 8
through ``run()`` (device and host control), the episode's reference and
pipelined bodies (deepstream, reducto and a ``camera_churn`` mask whose
dead cameras straddle a shard boundary), two stream windows with
checkpoints, the SLO ladder with one straggling rank and the supervisor
with a fault on one rank; 2 ranks restore that stream (from the port's checkpoint and
from JAX's copy of it) and run the profiling sweep at C=3; this process
restores it with no mesh.  Every sharded log equals the unsharded port's
bit for bit (the JAX package's own bounds are 1e-6 for ``run()`` and
1e-5 x scale for the episode; the port holds the exact result), and the
sharded ``run()`` matches JAX's within 1e-5 x scale (the harness's rule).
"""
import dataclasses
import shutil
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# every spawned rank takes a core of its own
torch.set_num_threads(1)

import _torch_sharded_worker as W  # noqa: E402
import harness  # noqa: E402
from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.core import elastic as j_elastic  # noqa: E402
from repro.data import synthetic as j_synth  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.core import scheduler as t_sched  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.data.synthetic import MultiCameraScene, SceneConfig  # noqa
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

LOG_KEYS = W.LOG_KEYS


class _Mesh:
    """A stand-in camera mesh of ``d`` ranks seen from ``rank`` (the layout
    functions read only its size and position)."""

    def __init__(self, d: int, rank: int = 0):
        self.d, self.rank = d, rank

    def size(self) -> int:
        return self.d

    def get_local_rank(self) -> int:
        return self.rank


def _equal(ref: dict, got: dict, what: str) -> None:
    for k in LOG_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=f"{what} {k}")


# -- the layout rules against JAX's -----------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_pad_cameras_matches_jax(d):
    jmesh = types.SimpleNamespace(shape={"camera": d})
    for n in (1, 2, 3, 5, 8, 9, 16, 17):
        assert rules.pad_cameras(n, _Mesh(d)) == \
            j_rules.pad_cameras(n, jmesh), (n, d)
        assert rules.pad_cameras(n, None) == j_rules.pad_cameras(n, None)
        rows = [rules.camera_rows(n, _Mesh(d, r)) for r in range(d)]
        assert rows[0][0] == 0 and rows[-1][1] == rules.pad_cameras(
            n, _Mesh(d))
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("fill", [0, 1.0, True])
def test_pad_leading_matches_jax(fill):
    x = np.random.default_rng(3).uniform(size=(5, 2, 3)).astype(np.float32)
    if fill is True:
        x = x > 0.5
    for n in (5, 6, 8):
        want = np.asarray(j_rules.pad_leading(jnp.asarray(x), n, fill=fill))
        got = rules.pad_leading(torch.from_numpy(x), n, fill).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("c_pad", [5, 8, 12])
def test_pad_scene_params_matches_jax(c_pad):
    cfg = SceneConfig(seed=11, num_cameras=5)
    want = j_synth.pad_scene_params(
        j_synth.init_device_scene(j_synth.SceneConfig(seed=11,
                                                      num_cameras=5)), c_pad)
    got = t_synth.pad_scene_params(t_synth.init_device_scene(cfg, "cpu"),
                                   c_pad)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_scene_rows_are_the_padded_fleet_split():
    """Each rank's rows of a DeviceScene (built from numpy, only its rows
    placed) are its block of the padded fleet."""
    cfg = SceneConfig(seed=11, num_cameras=5)
    whole = t_synth.pad_scene_params(t_synth.init_device_scene(cfg, "cpu"),
                                     8)
    for r in range(4):
        mesh = _Mesh(4, r)
        got = t_synth.init_device_scene(cfg, "cpu", mesh)
        for name, w, g in zip(whole._fields, whole, got):
            want = w if name == "objects" else w[2 * r:2 * r + 2]
            assert torch.equal(g, want), (r, name)


def test_single_process_has_no_mesh_and_gather_is_identity():
    """No process group: no camera mesh.  A one-rank group: ``camera_mesh``
    still gives None below ``min_devices`` = 2, the one-rank mesh's
    gather returns its input, ``agree`` hands back this rank's own
    values and error, and the registry of a ``shard="on"`` system holds
    the sharded graph keys."""
    assert not torch.distributed.is_initialized()
    assert rules.camera_mesh() is None and rules.camera_mesh(1) is None
    s = W.system(3)
    assert s.mesh is None
    mesh_mod.init_distributed("cpu", rank=0, world_size=1)
    try:
        assert rules.camera_mesh() is None
        mesh = rules.camera_mesh(min_devices=1)
        assert rules.mesh_cache_key(mesh) == (1, 0)
        x = torch.arange(12.0).reshape(3, 4)
        for dim in (0, 1):
            got = rules.gather(x, mesh, dim=dim)
            # contiguous: numpy's reductions over it sum in x's order
            assert torch.equal(got, x) and got.is_contiguous()
        flags = torch.tensor([True, False, True])
        assert torch.equal(rules.gather(flags, mesh), flags)
        assert torch.equal(rules.scatter(x, mesh), x)
        err, v = rules.agree(None, (1.5, 0.0), mesh, "cpu")
        assert err is None and v.tolist() == [1.5, 0.0]
        e = ValueError("mine")
        assert rules.agree(e, (), mesh, "cpu")[0] is e
        # the audit's registry on a system of the one-rank mesh names
        # the sharded graphs: their statics carry the mesh's key
        from repro_torch.analysis.programs import Canonical, get_programs
        progs = get_programs(kinds=["episode"], canon=Canonical(
            W.system(5, shard="on")), methods=("deepstream",))
        assert progs and all(p.statics.mesh_key == (1, 0)
                             and p.statics.c_pad == 5 for p in progs)
    finally:
        mesh_mod.shutdown()
    assert rules.camera_mesh(1) is None


def test_shard_config():
    assert t_sched.SystemConfig().shard == "auto"
    assert t_sched.SystemConfig(checked=True, shard="on").shard == "off"
    with pytest.raises(ValueError, match="shard"):
        t_sched.SystemConfig(shard="yes")
    # no mesh when sharding is off, unbatched or checked, or when "auto"
    # finds no group; "on" without a group is an error
    for kw in (dict(shard="off"), dict(shard="auto"),
               dict(shard="on", batched=False),
               dict(shard="on", checked=True)):
        assert W.system(3, **kw).mesh is None, kw
    with pytest.raises(ValueError, match="group"):
        W.system(3, shard="on")


def test_shutdown_drops_the_sharded_graphs():
    """``launch.mesh.shutdown`` forgets every episode graph captured on a
    mesh (it holds the group's communicator) and keeps the others."""
    from collections import namedtuple
    from repro_torch.core import fleet
    statics = namedtuple("statics", "mesh_key")
    sharded = (statics((1, 0)), "sharded")
    plain = (statics(None), "plain")
    fleet._GRAPHS.update({sharded: None, plain: None})
    try:
        mesh_mod.shutdown()
        assert sharded not in fleet._GRAPHS and plain in fleet._GRAPHS
    finally:
        fleet._GRAPHS.pop(sharded, None)
        fleet._GRAPHS.pop(plain, None)


def test_maybe_save_decides_on_the_agreed_flag():
    """A signal that lands after the ranks agreed (the flag set, the
    agreed value False) waits for the next boundary: no save, no exit
    off the ``every`` grid; the agreed True saves and exits on every
    rank, signalled or not."""
    from repro_torch.ft.watchdog import PreemptionCheckpointer
    saved = []
    cp = PreemptionCheckpointer(saved.append, every=4, install_signal=False)
    cp.preempted = True
    assert not cp.maybe_save(3, preempted=False) and saved == []
    cp.preempted = False
    with pytest.raises(SystemExit) as e:
        cp.maybe_save(5, preempted=True)
    assert e.value.code == 143 and saved == [5]


# -- the worlds -----------------------------------------------------------------

def _jax_run(detectors, method):
    js = harness.build_system(detectors, "pipelined", j_synth.SceneConfig(
        seed=W.SYSTEM_SEED, num_cameras=W.C))
    js._key = jax.random.PRNGKey(1234)
    return js.run(j_synth.DeviceScene(j_synth.SceneConfig(
        seed=W.SCENE_SEED, num_cameras=W.C)), W.trace(W.T_RUN),
        method=method)


def _jax_target(scfg):
    return {"est": j_elastic.init_state_jax(),
            "ref": jnp.zeros((W.C, scfg.height, scfg.width), jnp.float32),
            "live_prev": jnp.ones((W.C,), bool),
            "key": jax.random.PRNGKey(0)}


@pytest.fixture(scope="module")
def worlds(detectors, tmp_path_factory):
    """Both worlds' results beside the unsharded port's and JAX's, the
    unsharded ones computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("sharded")
    ctx4 = W.spawn(tmp, "world4", 4)
    ref = {}
    s = W.system()
    for method in ("deepstream", "reducto"):
        ref[f"run {method}"] = s.run(W.scene(), W.trace(W.T_RUN), method)
        ref[f"jax run {method}"] = _jax_run(detectors, method)
    ref["run host deepstream"] = W.system(alloc="host", pipeline=False).run(
        W.scene(), W.trace(W.T_RUN), "deepstream")
    ref["run host scene"] = s.run(W.host_scene(), W.trace(W.T_RUN),
                                  "deepstream")
    # the production body; the reference body equals it bit for bit
    # (tests/test_torch_pipeline.py)
    es = W.system(episode=True)
    for name, method, T, faults in W.episode_cases():
        ref[f"episode {name}"] = es.run(W.scene(), W.trace(T), method,
                                        faults=faults)
    # the continuous stream: 4 slots, then 2 more through the carry (one
    # run, tests/test_torch_pipeline.py)
    tr, live = W.stream_inputs()
    n = 2 * W.STREAM_WINDOW
    for method in ("deepstream", "reducto"):
        sc = W.scene()
        head = es.run_episode(sc, tr[:n], method, faults=live[:n])
        ref[f"carry {method}"] = es.last_carry
        ref[f"key {method}"] = es._key
        tail = es.run_episode(sc, tr[n:], method, faults=live[n:],
                              carry=es.last_carry)
        ref[f"stream {method}"] = {k: np.concatenate([head[k], tail[k]])
                                   for k in head}
    # the ladder's stream: one episode over its 10 slots (every rung serves
    # the same carry chain)
    tr, live = W.stream_inputs(W.LADDER_SLOTS)
    ref["ladder"] = es.run_episode(W.scene(), tr, "deepstream", faults=live)
    ref["checked"] = W.system(episode=True, checked=True).run(
        W.scene(), W.trace(W.T_RUN), "deepstream")
    p = W.system(W.PROFILE_C)
    ref["profile"] = p.profile(MultiCameraScene(SceneConfig(
        seed=9, num_cameras=W.PROFILE_C)), num_slots=1,
        mlp_steps=W.MLP_STEPS)
    ref["profile artifacts"] = W.artifacts(p)
    W.wait(ctx4)
    got4 = W.results(tmp, "world4", 4)

    # JAX restores the 4-rank checkpoints and writes them again in its
    # own package: the 2-rank world restores those copies too.  Each
    # resumed runner checkpoints into a directory of its own
    jscfg = j_synth.SceneConfig(seed=W.SYSTEM_SEED, num_cameras=W.C)
    jax_restored = {}
    for method in ("deepstream", "reducto"):
        src = tmp / f"ckpt_{method}"
        path = j_ckpt.generations(src)[-1]
        tree, meta = j_ckpt.restore(path, _jax_target(jscfg))
        jax_restored[method] = tree
        j_ckpt.save(tree, tmp / f"jax_ckpt_{method}" / path.name,
                    step=int(meta["window"]), metadata=meta)
        for copy in (f"w2_port_{method}", f"w1_port_{method}"):
            shutil.copytree(src, tmp / copy)
        shutil.copytree(tmp / f"jax_ckpt_{method}",
                        tmp / f"w2_jax_{method}")
    ctx2 = W.spawn(tmp, "world2", 2)
    for method in ("deepstream", "reducto"):
        r = W.runner(W.system(episode=True), method,
                     tmp / f"w1_port_{method}")
        assert r.restore() and r.t_next == 2 * W.STREAM_WINDOW
        W.serve(r, 2 * W.STREAM_WINDOW, W.STREAM_SLOTS)
        ref[f"one rank {method}"] = W.stream_logs(r)
    W.wait(ctx2)
    got2 = W.results(tmp, "world2", 2)
    yield types.SimpleNamespace(ref=ref, got4=got4, got2=got2,
                                jax_restored=jax_restored, tmp=tmp)
    shutil.rmtree(tmp, ignore_errors=True)


def test_layout(worlds):
    assert worlds.got4["layout"] == (8, 2)


def test_fleet_wrappers_on_the_mesh(worlds):
    """``roidet_fleet`` given the whole fleet and the mesh (the profile's
    call: each rank its rows, then a gather) equals the unsharded call
    bit for bit."""
    assert worlds.got4["roidet equal"]


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
def test_run_sharded_equals_unsharded_and_jax(worlds, method):
    """``run()`` batched at 4 ranks (C=5 padded to 8): the unsharded port's
    logs bit for bit, JAX's unsharded ``run()`` within 1e-5 x scale."""
    got = worlds.got4[f"run {method}"]
    _equal(worlds.ref[f"run {method}"], got, f"run {method}")
    harness.assert_logs_match(worlds.ref[f"jax run {method}"], got,
                              ctx=method)


def test_run_host_control_sharded(worlds):
    _equal(worlds.ref["run host deepstream"],
           worlds.got4["run host deepstream"], "host control")


def test_run_on_a_host_scene_sharded(worlds):
    """``run()`` on a host ``MultiCameraScene`` at 4 ranks (each renders
    the fleet and takes its rows, the padding black): the unsharded
    port's logs bit for bit."""
    _equal(worlds.ref["run host scene"], worlds.got4["run host scene"],
           "host scene")


@pytest.mark.parametrize("pipelined", [True, False])
@pytest.mark.parametrize("case", [c[0] for c in W.episode_cases()])
def test_episode_sharded_equals_unsharded(worlds, pipelined, case):
    """The episode at 4 ranks (a scene of the rank's rows): the unsharded
    port's logs bit for bit, with no per-slot keep or control fetch."""
    _equal(worlds.ref[f"episode {case}"],
           worlds.got4[f"episode {pipelined} {case}"],
           f"episode pipelined={pipelined} {case}")
    fetches = worlds.got4[f"fetches {pipelined} {case}"]
    assert fetches["keep"] == 0 and fetches["control"] == 0, fetches
    assert fetches["harvest"] == 2, fetches


def test_sharded_system_refuses_a_whole_fleet_scene(worlds):
    """Under a mesh a DeviceScene must be built on it (its params the
    rank's rows): a whole-fleet scene raises on every rank alike."""
    assert worlds.got4["whole scene"] == "refused"


def test_stream_ladder_agrees_across_ranks(worlds):
    """Rank 1 alone reports slow windows: the ranks agree on the slowest
    wall, so every rank walks the same rungs (the cross-rank check of
    ``W.results``), and the logs are the unsharded episode's."""
    rungs, last, logs = worlds.got4["ladder"]
    # the rung each window was served at; a slow window degrades the next
    assert rungs == ["episode", "episode", "episode_small", "episode_small",
                     "pipelined"]
    assert last == "pipelined"
    _equal(worlds.ref["ladder"], logs, "ladder")


def test_supervisor_retries_together_after_one_rank_fails(worlds):
    """A fault hook raising on rank 2 alone fails the first attempt on
    every rank (the others' error names rank 2); all retry, and the logs
    are the unsharded episode's."""
    events, named, logs = worlds.got4["supervisor"]
    assert events == [("retry", "episode", 0), ("ok", "episode", 1)]
    assert named
    _equal(worlds.ref["episode deepstream"], logs, "supervisor")


def test_churn_straddles_a_shard_boundary():
    dead = ~W.churn()
    # rows 0-1 are rank 0's, 2-3 rank 1's, 4 (+3 padding) rank 2's
    assert any(d[1] and d[2] for d in dead)


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
def test_stream_resumes_at_any_world_size(worlds, method):
    """Two windows at 4 ranks with checkpoints; restored at 2 ranks (from
    the port's checkpoint and from JAX's copy of it) and at 1 rank with
    no mesh, each continues to the unsharded continuous run's logs."""
    want = worlds.ref[f"stream {method}"]
    n = 2 * W.STREAM_WINDOW
    head = {k: v[:n] for k, v in want.items()}
    _equal(head, worlds.got4[f"stream {method}"], f"stream {method} 4 ranks")
    for what in (f"stream {method} port", f"stream {method} jax"):
        _equal(want, worlds.got2[what], what)
    _equal(want, worlds.ref[f"one rank {method}"], f"{method} one rank")


@pytest.mark.parametrize("method", ["deepstream", "reducto"])
def test_checkpoint_round_trips_with_jax(worlds, method):
    """JAX's ``ckpt.restore`` reads the 4-rank checkpoint: the whole
    fleet's (C, H, W) reference, the elastic state and the run key of the
    unsharded run at the same slot; the port's restore reads JAX's copy
    to the same leaves."""
    tree = worlds.jax_restored[method]
    carry = worlds.ref[f"carry {method}"]
    np.testing.assert_array_equal(np.asarray(tree["ref"]),
                                  carry.ref.numpy())
    for name, x in zip(carry.est._fields, carry.est):
        np.testing.assert_array_equal(np.asarray(getattr(tree["est"], name)),
                                      x.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(tree["live_prev"]),
                                  carry.live_prev)
    np.testing.assert_array_equal(
        np.asarray(tree["key"]).astype(np.int64),
        worlds.ref[f"key {method}"].numpy())
    path = t_ckpt.generations(worlds.tmp / f"jax_ckpt_{method}")[-1]
    r = W.runner(W.system(episode=True), method)
    back, _ = t_ckpt.restore(path, r._carry_target())
    assert torch.equal(back["ref"], carry.ref)


def test_preemption_on_one_rank_saves_on_all(worlds):
    """SIGTERM's flag set on rank 1 alone: the ranks agree at the window
    boundary, every rank takes part in the checkpoint (rank 0 writes it)
    and exits with 143."""
    assert worlds.got4["preempt"] == (143, ["window_00000001"])


def test_profile_sweep_sharded(worlds):
    """The sweep's C*R*2 entries split over 2 ranks (C=3, 1 slot): the
    unsharded run's profile, MLP, thresholds, jcab table and key chain."""
    assert worlds.got2["profile"] == worlds.ref["profile"]
    want, got = worlds.ref["profile artifacts"], worlds.got2[
        "profile artifacts"]
    for k in want["mlp"]:
        np.testing.assert_array_equal(got["mlp"][k], want["mlp"][k])
    assert got["tau"] == want["tau"]
    np.testing.assert_array_equal(got["jcab"], want["jcab"])
    np.testing.assert_array_equal(got["key"], want["key"])


def test_checked_runs_unsharded(worlds):
    """``checked=True`` with ``shard="auto"`` in a 4-rank world has no
    mesh and logs the single process's checked run."""
    assert worlds.got4["checked unsharded"]
    _equal(worlds.ref["checked"], worlds.got4["checked"], "checked")
