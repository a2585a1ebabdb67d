"""The rank bodies of ``tests/test_torch_sharded.py``.

Each spawned process joins a gloo group through a file under the test's
``tmp_path`` (no port, so parallel test workers cannot clash), runs one
world's cases on the CPU with one intra-op thread, and rank 0 pickles
what it saw; every rank checks that it saw the same logs as rank 0.  The
module imports no JAX: the children load only the port.
"""
from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import numpy as np
import torch

C = 5                       # the fleet: padded to 8 on 4 ranks
SYSTEM_SEED, SCENE_SEED = 5, 33
W_CAP_KBPS = 8000.0         # tests/harness.py W_CAP_KBPS
T_RUN, T_EP, T_CHURN = 2, 2, 3
CHURN_SEED = 2              # slot 2 has cameras 1 and 2 dead: ranks 0 and 1
STREAM_WINDOW = 2
STREAM_SLOTS = 6            # 2 windows at 4 ranks, the rest after a restore
LADDER_SLOTS = 10           # 5 windows: two degrades, the last pipelined
PROFILE_C = 3
MLP_STEPS = 20
LOG_KEYS = ("utility", "mean_f1", "bytes", "W", "extra", "alloc_kbps",
            "area")


def system(num_cams: int = C, **kw):
    """The harness's fixed artifacts on a port system (untrained MLP from
    PRNGKey(0), tau 10/50, the linspace jcab table, the pinned capacity),
    as ``tests/test_sharded.py`` builds JAX's."""
    from repro_torch.common import prng
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.core.utility import init_utility_mlp
    from repro_torch.data.synthetic import SceneConfig
    from repro_torch.models.detector import load_detector
    kw.setdefault("w_cap_kbps", W_CAP_KBPS)
    cfg = SystemConfig(scene=SceneConfig(seed=SYSTEM_SEED,
                                         num_cameras=num_cams),
                       eval_frames=3, **kw)
    s = DeepStreamSystem(cfg, load_detector("light", "cpu"),
                         load_detector("server", "cpu"), device="cpu")
    s.mlp = init_utility_mlp(prng.PRNGKey(0))
    s.tau_wl, s.tau_wh = 10.0, 50.0
    s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    return s


def scene(num_cams: int = C, mesh=None):
    from repro_torch.data.synthetic import DeviceScene, SceneConfig
    return DeviceScene(SceneConfig(seed=SCENE_SEED, num_cameras=num_cams),
                       device="cpu", mesh=mesh)


def host_scene():
    from repro_torch.data.synthetic import MultiCameraScene, SceneConfig
    return MultiCameraScene(SceneConfig(seed=SCENE_SEED, num_cameras=C))


def trace(T: int) -> np.ndarray:
    """``tests/test_sharded.py``'s trace, scaled to its 5 cameras."""
    from repro_torch.data.synthetic import bandwidth_trace
    return bandwidth_trace("medium", T, seed=8) * 3 / 5


def churn(T: int = T_CHURN) -> np.ndarray:
    from repro_torch.data.scenarios import make_faults
    return make_faults("camera_churn", T, C, seed=CHURN_SEED)


def stream_inputs(slots: int = STREAM_SLOTS):
    from repro_torch.data.scenarios import make_soak_stream
    return make_soak_stream(slots, num_cams=C)


def ladder_watchdog():
    """A watchdog that degrades on the first slow window after one of
    warm-up (``WatchdogConfig``'s defaults need 8 windows)."""
    from repro_torch.ft.watchdog import WatchdogConfig
    return WatchdogConfig(warmup_steps=1, escalate_after=1)


def runner(s, method: str, ckpt_dir=None, wall_hook=None, **kw):
    """A stream runner over a scene built on the system's mesh."""
    from repro_torch.serve.stream import StreamConfig, StreamingFleetRunner
    return StreamingFleetRunner(
        s, scene(mesh=s.mesh), method=method,
        cfg=StreamConfig(window_slots=STREAM_WINDOW,
                         ckpt_dir=None if ckpt_dir is None
                         else str(ckpt_dir), **kw), wall_hook=wall_hook)


def serve(r, lo: int, hi: int, slots: int = STREAM_SLOTS) -> None:
    """Offer and serve slots [lo, hi) of the stream, window by window."""
    tr, live = stream_inputs(slots)
    r.offer(tr[lo:hi], faults=live[lo:hi])
    assert r.serve() == (hi - lo) // STREAM_WINDOW
    r.close()


def stream_logs(r) -> dict:
    return {k: np.asarray(v) for k, v in r.logs.items()}


def episode_cases():
    """(name, method, T, faults) of the episode comparisons."""
    return (("deepstream", "deepstream", T_EP, None),
            ("reducto", "reducto", T_EP, None),
            ("churn deepstream", "deepstream", T_CHURN, churn()),
            ("churn reducto", "reducto", T_CHURN, churn()))


def world4(tmp: Path) -> dict:
    """C=5 on 4 ranks: run() (device and host control), the episode's
    reference and pipelined bodies, two stream windows with checkpoints,
    and a checked system."""
    from repro_torch.core import scheduler as sched
    from repro_torch.sharding import rules
    out = {}
    s = system()
    assert s.mesh is not None and rules.mesh_size(s.mesh) == 4
    out["layout"] = (rules.pad_cameras(C, s.mesh),
                     rules.local_count(C, s.mesh))
    me = rules.mesh_rank(s.mesh)
    # the whole-fleet ROIDet (the profile's): each rank its rows, gathered
    from repro_torch.core import roidet
    frames = scene().segment()["frames"]
    whole = roidet.roidet_fleet(frames, s.light)
    out["roidet equal"] = all(
        torch.equal(a, b) for a, b in zip(
            roidet.roidet_fleet(frames, s.light, mesh=s.mesh), whole))
    for method in ("deepstream", "reducto"):
        out[f"run {method}"] = s.run(scene(mesh=s.mesh), trace(T_RUN),
                                     method)
    out["run host deepstream"] = system(alloc="host", pipeline=False).run(
        scene(mesh=s.mesh), trace(T_RUN), "deepstream")
    # a host scene: rendered whole on every rank, each taking its rows
    out["run host scene"] = s.run(host_scene(), trace(T_RUN), "deepstream")
    for pipelined in (True, False):
        es = system(episode=True, episode_pipelined=pipelined)
        for name, method, T, faults in episode_cases():
            before = sched.d2h_fetch_counts()
            out[f"episode {pipelined} {name}"] = es.run(
                scene(mesh=es.mesh), trace(T), method, faults=faults)
            after = sched.d2h_fetch_counts()
            out[f"fetches {pipelined} {name}"] = {
                k: after[k] - before[k] for k in after}
    # a scene of the whole fleet is refused on every rank alike, before
    # any collective
    try:
        es.run(scene(), trace(T_EP), "deepstream")
        out["whole scene"] = "served"
    except ValueError as e:
        out["whole scene"] = "refused" if "mesh" in str(e) else str(e)
    for method in ("deepstream", "reducto"):
        r = runner(system(episode=True), method, tmp / f"ckpt_{method}")
        serve(r, 0, 2 * STREAM_WINDOW)
        out[f"stream {method}"] = stream_logs(r)
    # the SLO ladder with one straggler: rank 1 alone reports a slow
    # turnaround on odd windows; the agreed (slowest) wall degrades every
    # rank alike, episode -> episode_small -> pipelined
    r = runner(system(episode=True), "deepstream",
               wall_hook=lambda w, wall: 100.0 if me == 1 and w % 2 else wall,
               watchdog=ladder_watchdog())
    serve(r, 0, LADDER_SLOTS, LADDER_SLOTS)
    out["ladder"] = ([e["rung"] for e in r.events if e["kind"] == "window"],
                     r.stats()["rung"], stream_logs(r))
    # a fault hook failing on rank 2 alone: every rank fails the attempt
    # and retries it together
    from repro_torch.core.scheduler import EpisodeSupervisor

    def fault(attempt, mode):
        if me == 2 and attempt == 0:
            raise RuntimeError("injected on rank 2")

    sup = EpisodeSupervisor(system(episode=True), fault_hook=fault)
    logs = sup.run(scene(mesh=s.mesh), trace(T_EP), "deepstream")
    err = sup.events[0].get("error", "")
    out["supervisor"] = (
        [(e["kind"], e["mode"], e["attempt"]) for e in sup.events],
        ("injected" if me == 2 else "camera-mesh rank 2 failed") in err,
        logs)
    # a preemption signal on rank 1 alone: every rank saves at the window
    # boundary (the checkpoint's gather is collective) and exits 143
    import signal
    from repro_torch.ckpt import checkpoint as ckpt
    r = runner(system(episode=True), "deepstream", tmp / "ckpt_preempt",
               install_signal=True)
    if me == 1:
        r.checkpointer.preempted = True
        r.checkpointer.preempt_signum = signal.SIGTERM
    tr, live = stream_inputs()
    r.offer(tr[:STREAM_WINDOW], faults=live[:STREAM_WINDOW])
    try:
        r.serve()
        code = None
    except SystemExit as e:
        code = e.code
    r.close()
    torch.distributed.barrier()     # rank 0's save has committed
    out["preempt"] = (code, [p.name for p in ckpt.generations(
        tmp / "ckpt_preempt")])
    cs = system(episode=True, checked=True)
    out["checked unsharded"] = cs.mesh is None
    out["checked"] = cs.run(scene(), trace(T_RUN), "deepstream")
    return out


def world2(tmp: Path) -> dict:
    """2 ranks: the stream restored from the 4-rank checkpoint (and from
    its copy written by JAX) and served on; the profile sweep at C=3."""
    from repro_torch.data.synthetic import MultiCameraScene, SceneConfig
    out = {}
    for method in ("deepstream", "reducto"):
        for src in ("port", "jax"):
            r = runner(system(episode=True), method,
                       tmp / f"w2_{src}_{method}")
            assert r.restore() and r.t_next == 2 * STREAM_WINDOW
            serve(r, 2 * STREAM_WINDOW, STREAM_SLOTS)
            out[f"stream {method} {src}"] = stream_logs(r)
    s = system(PROFILE_C)
    out["profile"] = s.profile(MultiCameraScene(SceneConfig(
        seed=9, num_cameras=PROFILE_C)), num_slots=1, mlp_steps=MLP_STEPS)
    out["profile artifacts"] = artifacts(s)
    return out


def artifacts(s) -> dict:
    """What ``profile()`` leaves on a system, as numpy."""
    return {"mlp": {k: v.detach().numpy().copy() for k, v in s.mlp.items()},
            "tau": (s.tau_wl, s.tau_wh), "jcab": s.jcab_table,
            "key": s._key.numpy().copy()}


def _same(a, b, what: str) -> None:
    """Every rank's results equal rank 0's, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def entry(rank: int, world: int, name: str, tmp: str) -> None:
    """One rank of world ``name`` (``world4`` / ``world2``)."""
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_mod
    tmp = Path(tmp)
    mesh_mod.init_distributed("cpu", rank=rank, world_size=world,
                              init_method=f"file://{tmp / (name + '.pg')}")
    try:
        out = globals()[name](tmp)
        (tmp / f"{name}.{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        mesh_mod.shutdown()


def results(tmp: Path, name: str, world: int) -> dict:
    """Rank 0's results, after checking every rank's against them."""
    got = [pickle.loads((tmp / f"{name}.{r}.pkl").read_bytes())
           for r in range(world)]
    for r in range(1, world):
        _same(got[0], got[r], f"rank {r} vs rank 0")
    return got[0]


def spawn(tmp: Path, name: str, world: int):
    """Start world ``name`` of ``world`` ranks without waiting for it."""
    import torch.multiprocessing as mp
    return mp.spawn(entry, args=(world, name, str(tmp)), nprocs=world,
                    join=False)


def wait(ctx, seconds: float = 600.0) -> None:
    """Join a spawned world (a rank's exception is raised here); a world
    still running after ``seconds`` (a collective that never completes)
    is killed and fails."""
    import time
    deadline = time.monotonic() + seconds
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a spawned world ran past {seconds} s")
