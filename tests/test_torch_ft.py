"""The port's fault-tolerance layer against the JAX package's: the
straggler watchdog's verdicts, the preemption checkpointer under real
signals, the chaos engine's seeded draws and schedules, and checkpoints in
both directions (a carry written by the port restores in JAX's
``ckpt.restore`` bitwise, and JAX's in the port's), with the corruption
battery, generation fallback and retention."""
import json
import os
import shutil
import signal
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.core import elastic as j_elastic  # noqa: E402
from repro.data import scenarios as j_scen  # noqa: E402
from repro.ft import chaos as j_chaos  # noqa: E402
from repro.ft import watchdog as j_wd  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core import elastic as t_elastic  # noqa: E402
from repro_torch.data import scenarios as t_scen  # noqa: E402
from repro_torch.ft import chaos as t_chaos  # noqa: E402
from repro_torch.ft import watchdog as t_wd  # noqa: E402


# -- the watchdog -------------------------------------------------------------

def _jitter(n, base=0.1):
    """The healthy step times of the JAX package's watchdog tests."""
    return [base * (1 + 0.01 * ((i % 3) - 1)) for i in range(n)]


# (watchdog config, step times, steps after which the gate is rebaselined)
WATCHDOG_CASES = {
    "warmup outlier": (dict(warmup_steps=5), [30.0] + [0.1] * 4, ()),
    "detect escalate recover": (dict(warmup_steps=5, escalate_after=3),
                                _jitter(10) + [1.0] * 3 + [0.1, 1.0], ()),
    "stragglers keep the baseline": (dict(warmup_steps=5),
                                     _jitter(10) + [5.0] * 3, ()),
    "rebaseline": (dict(warmup_steps=5, escalate_after=3),
                   _jitter(10) + [1.0] + [1.0] * 6, (11,)),
    "degraded rung seeding": (dict(warmup_steps=1, escalate_after=1),
                              [5.0] * 6 + [1.0, 1.0, 4.0], (6,)),
    "ladder walls": (dict(warmup_steps=1, escalate_after=1),
                     [1.0, 1.0, 6.0, 1.0, 6.0, 1.0, 1.0, 1.0, 1.0], (3, 5)),
}


def _drive(mod, cfg, times, rebase):
    wd = mod.Watchdog(mod.WatchdogConfig(**cfg))
    verdicts = []
    for i, t in enumerate(times):
        if i in rebase:
            wd.rebaseline()
        verdicts.append(wd.record(i, t))
    st = wd.stats
    return verdicts, (st.ema, st.var, st.count, st.violations, st.events)


@pytest.mark.parametrize("case", sorted(WATCHDOG_CASES))
def test_watchdog_verdicts_match_jax(case):
    cfg, times, rebase = WATCHDOG_CASES[case]
    want = _drive(j_wd, cfg, times, rebase)
    got = _drive(t_wd, cfg, times, rebase)
    assert got == want
    assert any(v != "ok" for v in got[0]) or case == "warmup outlier"


def test_simulated_fleet_matches_jax():
    fleets = [mod.SimulatedFleet(4, base_step_time=0.1, seed=1)
              for mod in (j_wd, t_wd)]
    for step in range(12):
        if step == 6:
            for f in fleets:
                f.inject_straggler(3, factor=10.0)
        if step == 9:
            for f in fleets:
                f.kill(1)
        a, b = (f.step_times() for f in fleets)
        np.testing.assert_array_equal(a, b)
    assert np.isinf(fleets[1].synchronous_step_time())


def test_checkpointer_periodic_saves():
    saved = []
    ck = t_wd.PreemptionCheckpointer(saved.append, every=3,
                                     install_signal=False)
    for step in range(1, 8):
        ck.maybe_save(step)
    assert saved == [3, 6]


@pytest.mark.parametrize("sig,code", [(signal.SIGTERM, 143),
                                      (signal.SIGINT, 130)])
def test_checkpointer_signal_saves_now_and_exits(sig, code):
    """A real SIGTERM or SIGINT: save at the next boundary, then exit
    128 + signum; Python's KeyboardInterrupt handler is not chained."""
    saved = []
    with t_wd.PreemptionCheckpointer(saved.append, every=100,
                                     install_signal=True) as ck:
        assert not ck.maybe_save(1)
        signal.raise_signal(sig)
        assert ck.preempted and ck.preempt_signum == sig
        with pytest.raises(SystemExit) as exc:
            ck.maybe_save(2)
        assert exc.value.code == code and saved == [2]


def test_checkpointer_chains_and_restores_previous_handler():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        ck = t_wd.PreemptionCheckpointer([].append, every=100,
                                         install_signal=True)
        signal.raise_signal(signal.SIGTERM)
        assert ck.preempted and hits == [signal.SIGTERM]
        ck.close()
        assert signal.getsignal(signal.SIGTERM) is not ck._on_signal
        signal.raise_signal(signal.SIGTERM)
        assert hits == [signal.SIGTERM] * 2
    finally:
        signal.signal(signal.SIGTERM, prev)


# -- the chaos engine -----------------------------------------------------------

@pytest.mark.parametrize("seed,parts", [(0, ()), (7, ("ckpt.bitflip", 3)),
                                        (11, ("ingest.reorder", 41)),
                                        (2 ** 31 - 1, ("x", "y", 0))])
def test_fold_rng_matches_jax(seed, parts):
    a, b = j_chaos.fold_rng(seed, *parts), t_chaos.fold_rng(seed, *parts)
    np.testing.assert_array_equal(a.integers(0, 1 << 30, 16),
                                  b.integers(0, 1 << 30, 16))
    np.testing.assert_array_equal(a.uniform(size=8), b.uniform(size=8))


def test_registry_matches_jax():
    assert t_chaos.SITES == j_chaos.SITES
    assert t_chaos.RECOVERABLE_SITES == j_chaos.RECOVERABLE_SITES


@pytest.mark.parametrize("poisoned", [False, True])
def test_schedule_json_roundtrip_across_packages(poisoned):
    sched = t_scen.make_chaos_schedule(96, 8, seed=3, poisoned=poisoned)
    assert sched == j_scen.make_chaos_schedule(96, 8, seed=3,
                                               poisoned=poisoned)
    specs = {k: t_chaos.SiteSpec.of(v) for k, v in sched.items()}
    text = t_chaos.schedule_to_json(specs)
    assert text == j_chaos.schedule_to_json(
        {k: j_chaos.SiteSpec.of(v) for k, v in sched.items()})
    assert t_chaos.schedule_from_json(text) == specs
    back = j_chaos.schedule_from_json(text)
    assert {k: (v.at, v.rate, v.mag) for k, v in back.items()} == \
        {k: (v.at, v.rate, v.mag) for k, v in specs.items()}


def test_engine_decisions_match_jax():
    sched = {"serve.exception": {"at": [5]}, "ingest.gap": {"rate": 0.5},
             "source.stall": {"at": [1, 2], "rate": 0.25}}
    je, te = j_chaos.ChaosEngine(3, sched), t_chaos.ChaosEngine(3, sched)
    for site in sched:
        assert [je.scheduled(site, t) for t in range(64)] == \
            [te.scheduled(site, t) for t in range(64)]
    fired = [(site, t, te.fire(site, t), je.fire(site, t))
             for site in sched for t in (0, 1, 5, 5, 9, 1)]
    assert all(a == b for *_, a, b in fired)
    assert not te.fire("serve.exception", 5)       # consumed once
    assert te.scheduled("serve.exception", 5)      # ... still scheduled
    assert te.events == je.events and te.counts() == je.counts()
    with pytest.raises(ValueError, match="unknown chaos sites"):
        t_chaos.ChaosEngine(0, {"ckpt.made_up": {"at": [1]}})


def test_engine_fires_each_pair_once_across_threads():
    """Two threads firing the same sites: each (site, step) fires once and
    every firing is in the event log."""
    sched = {"ckpt.bitflip": {"rate": 1.0}, "serve.exception": {"rate": 1.0}}
    eng = t_chaos.ChaosEngine(0, sched)
    wins = []

    def worker():
        wins.append(sum(eng.fire(site, t) for t in range(200)
                        for site in sched))
    threads = [threading.Thread(target=worker) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert sum(wins) == 400 and len(eng.events) == 400
    assert sorted((e["step"], e["site"]) for e in eng.events) == \
        sorted((t, s) for t in range(200) for s in sched)


# -- checkpoints ------------------------------------------------------------------

def _values(seed):
    rng = np.random.default_rng(seed)
    return dict(a_ema=np.float32(0.3173 + seed), a_var=np.float32(0.0442),
                debt=np.float32(-11.625 + seed), init=bool(seed % 2 == 0),
                ref=rng.standard_normal((3, 24, 32)).astype(np.float32),
                live=np.array([True, False, seed % 2 == 1]),
                key=1234 + seed)


def _port_tree(seed=7):
    v = _values(seed)
    t = lambda x: torch.tensor(x)
    return {"est": t_elastic.ElasticState(t(v["a_ema"]), t(v["a_var"]),
                                          t(v["debt"]), t(v["init"])),
            "ref": torch.from_numpy(v["ref"]),
            "live_prev": v["live"], "key": prng.PRNGKey(v["key"])}


def _jax_tree(seed=7):
    v = _values(seed)
    return {"est": j_elastic.ElasticStateJax(
                jnp.float32(v["a_ema"]), jnp.float32(v["a_var"]),
                jnp.float32(v["debt"]), jnp.asarray(v["init"])),
            "ref": jnp.asarray(v["ref"]), "live_prev": jnp.asarray(v["live"]),
            "key": jax.random.PRNGKey(v["key"])}


def _port_target():
    return {"est": t_elastic.init_state("cpu"),
            "ref": torch.zeros((3, 24, 32)),
            "live_prev": np.ones(3, bool),
            "key": torch.zeros(2, dtype=torch.int64)}


def _jax_target():
    return jax.tree.map(jnp.zeros_like, _jax_tree())


KEY_U32 = {"['key']": np.uint32}


def _host(tree):
    """[(key string, numpy leaf)] of either package's tree."""
    if isinstance(tree["ref"], torch.Tensor):
        return [(k, np.asarray(v)) for k, v in
                t_ckpt._flatten(t_ckpt.snapshot(tree))]
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in leaves]


def _assert_same(a, b, key_as=None):
    ha, hb = _host(a), _host(b)
    assert [k for k, _ in ha] == [k for k, _ in hb]
    for (k, x), (_, y) in zip(ha, hb):
        if k == "['key']" and key_as is not None:
            x, y = x.astype(key_as), y.astype(key_as)
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_port_checkpoint_is_jax_format(tmp_path):
    """The port's save of a carry equals the JAX package's save of the
    same values leaf for leaf: key strings, shapes, dtypes, codec and raw
    crc32; JAX restores it bitwise."""
    t_ckpt.save(_port_tree(), tmp_path / "port", step=3,
                metadata={"t_next": 8}, dtypes=KEY_U32)
    j_ckpt.save(_jax_tree(), tmp_path / "jax", step=3,
                metadata={"t_next": 8})
    mp, mj = (json.loads((tmp_path / d / "manifest.json").read_text())
              for d in ("port", "jax"))
    assert mp["format"] == mj["format"] == 2
    assert mp["metadata"] == mj["metadata"] and mp["step"] == mj["step"]
    assert list(mp["leaves"]) == list(mj["leaves"])
    for k in mj["leaves"]:
        a, b = mp["leaves"][k], mj["leaves"][k]
        for f in ("shape", "dtype", "codec", "crc32", "raw_nbytes", "file"):
            assert a[f] == b[f], (k, f)
    got, meta = j_ckpt.restore(tmp_path / "port", _jax_target())
    _assert_same(_jax_tree(), got)
    assert meta == {"t_next": 8, "step": 3}


def test_jax_checkpoint_restores_in_port(tmp_path):
    """JAX's checkpoint in the port: values bitwise, the uint32 key cast
    to the port's int64, tensors on the target's device."""
    j_ckpt.save(_jax_tree(), tmp_path / "jax", step=5, metadata={"w": 1})
    got, meta = t_ckpt.restore(tmp_path / "jax", _port_target())
    _assert_same(_port_tree(), got)
    assert got["key"].dtype == torch.int64 and got["ref"].device.type == "cpu"
    assert isinstance(got["live_prev"], np.ndarray)
    assert meta == {"w": 1, "step": 5}


def test_async_save_roundtrip(tmp_path):
    saver = t_ckpt.AsyncSaver()
    saver.save(_port_tree(), tmp_path / "w1", step=1, dtypes=KEY_U32)
    saver.wait()
    got, _ = t_ckpt.restore(tmp_path / "w1", _port_target())
    _assert_same(_port_tree(), got)
    assert len(saver.snapshot_s) == len(saver.write_s) == 1


def test_crash_between_write_and_commit_falls_back(tmp_path, monkeypatch):
    """A save killed after the staging directory is complete (marker
    included) but before the rename is not committed."""
    t_ckpt.save(_port_tree(1), tmp_path / "w1", step=1, dtypes=KEY_U32)
    real_rename = os.rename

    def crash_rename(src, dst):
        if str(src).endswith(".tmp"):
            raise OSError("simulated kill before atomic rename")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", crash_rename)
    with pytest.raises(OSError, match="simulated kill"):
        t_ckpt.save(_port_tree(2), tmp_path / "w2", step=2, dtypes=KEY_U32)
    monkeypatch.undo()
    assert (tmp_path / "w2.tmp" / t_ckpt.COMMIT_MARKER).exists()
    assert not t_ckpt.is_committed(tmp_path / "w2.tmp")
    assert t_ckpt.latest_committed(tmp_path) == tmp_path / "w1"
    assert t_ckpt.generations(tmp_path) == j_ckpt.generations(tmp_path)
    got, meta = t_ckpt.restore(tmp_path / "w1", _port_target())
    _assert_same(_port_tree(1), got)
    t_ckpt.save(_port_tree(2), tmp_path / "w2", step=2, dtypes=KEY_U32)
    assert t_ckpt.latest_committed(tmp_path) == tmp_path / "w2"
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(tmp_path / "nowhere", _port_target())


def _gens(tmp_path, n=3):
    for w in range(1, n + 1):
        t_ckpt.save(_port_tree(w), tmp_path / f"window_{w:08d}", step=w,
                    metadata={"w": w}, dtypes=KEY_U32)


def _corrupt(kind, path):
    rng = np.random.default_rng(0)
    {"bitflip": t_chaos.corrupt_bitflip, "truncate": t_chaos.corrupt_truncate,
     "torn_manifest": t_chaos.corrupt_torn_manifest}[kind](path, rng)


@pytest.mark.parametrize("kind", ["bitflip", "truncate", "torn_manifest"])
def test_corruption_battery(tmp_path, kind):
    """Each corruption fails verification naming the leaf (or the
    manifest), with the JAX package's diagnosis; restore refuses it in
    both packages; the fallback is the generation before, bitwise."""
    _gens(tmp_path, 3)
    latest = t_ckpt.latest_committed(tmp_path)
    assert t_ckpt.verify_checkpoint(latest) == []
    _corrupt(kind, latest)
    errors = t_ckpt.verify_checkpoint(latest)
    assert errors and errors == j_ckpt.verify_checkpoint(latest)
    msg = " | ".join(errors)
    if kind == "torn_manifest":
        assert "manifest.json" in msg
    else:
        assert "leaf ['" in msg and any(
            s in msg for s in ("crc32", "truncated", "decompress",
                               "raw_nbytes"))
    with pytest.raises(t_ckpt.CheckpointCorruptError):
        t_ckpt.restore(latest, _port_target())
    with pytest.raises(j_ckpt.CheckpointCorruptError):
        j_ckpt.restore(latest, _jax_target())
    assert t_ckpt.latest_valid(tmp_path) == tmp_path / "window_00000002"
    got, meta = t_ckpt.restore(t_ckpt.latest_valid(tmp_path), _port_target())
    _assert_same(_port_tree(2), got)
    assert meta["w"] == 2


def test_all_generations_corrupt_yields_none(tmp_path):
    _gens(tmp_path, 2)
    for p in t_ckpt.generations(tmp_path):
        _corrupt("truncate", p)
    assert t_ckpt.latest_valid(tmp_path) is None


def test_format1_checkpoint_restores_unchecked(tmp_path):
    t_ckpt.save(_port_tree(), tmp_path / "w1", step=1, dtypes=KEY_U32)
    mf = tmp_path / "w1" / "manifest.json"
    doc = json.loads(mf.read_text())
    for ent in doc["leaves"].values():
        ent.pop("crc32"), ent.pop("raw_nbytes")
    doc["format"] = 1
    mf.write_text(json.dumps(doc))
    assert t_ckpt.verify_checkpoint(tmp_path / "w1") == []
    got, _ = t_ckpt.restore(tmp_path / "w1", _port_target())
    _assert_same(_port_tree(), got)


def test_gc_keeps_last_n(tmp_path):
    _gens(tmp_path, 5)
    removed = t_ckpt.gc_generations(tmp_path, keep=2)
    assert [p.name for p in removed] == [f"window_{w:08d}" for w in (1, 2, 3)]
    assert [p.name for p in t_ckpt.generations(tmp_path)] == \
        ["window_00000004", "window_00000005"]


def test_gc_never_removes_newest_valid(tmp_path):
    _gens(tmp_path, 4)
    _corrupt("bitflip", tmp_path / "window_00000003")
    _corrupt("torn_manifest", tmp_path / "window_00000004")
    removed = t_ckpt.gc_generations(tmp_path, keep=1)
    names = [p.name for p in t_ckpt.generations(tmp_path)]
    assert names == ["window_00000002", "window_00000004"]
    assert [p.name for p in removed] == ["window_00000001", "window_00000003"]
    # the only valid generation under corrupt newer ones survives keep=1
    shutil.rmtree(tmp_path / "window_00000004")
    for w in (5, 6):
        t_ckpt.save(_port_tree(w), tmp_path / f"window_{w:08d}", step=w,
                    dtypes=KEY_U32)
        _corrupt("truncate", tmp_path / f"window_{w:08d}")
    t_ckpt.gc_generations(tmp_path, keep=1)
    assert t_ckpt.latest_valid(tmp_path) == tmp_path / "window_00000002"
    with pytest.raises(ValueError, match="keep must be >= 1"):
        t_ckpt.AsyncSaver(keep=0)


def test_async_saver_gc_and_chaos_hooks(tmp_path):
    """Retention after each commit, the chaos hooks at the save
    boundaries, and the chaos-corrupted latest skipped by fallback."""
    eng = t_chaos.ChaosEngine(0, {"ckpt.bitflip": {"at": [3]},
                                  "ckpt.save_latency": {"at": [2],
                                                        "mag": 0.0}})
    saver = t_ckpt.AsyncSaver(keep=2, chaos=eng)
    for w in range(1, 4):
        saver.save(_port_tree(w), tmp_path / f"window_{w:08d}", step=w,
                   dtypes=KEY_U32, blocking=w == 3)
    saver.wait()
    assert {e["site"] for e in eng.events} == {"ckpt.bitflip",
                                               "ckpt.save_latency"}
    assert [p.name for p in t_ckpt.generations(tmp_path)] == \
        ["window_00000002", "window_00000003"]
    assert saver.gc_removed == [str(tmp_path / "window_00000001")]
    assert t_ckpt.latest_valid(tmp_path) == tmp_path / "window_00000002"
    got, _ = t_ckpt.restore(tmp_path / "window_00000002", _port_target())
    _assert_same(_port_tree(2), got)


def test_snapshot_keeps_structure_and_dtypes():
    tree = _port_tree()
    host = t_ckpt.snapshot(tree)
    assert isinstance(host["est"], t_elastic.ElasticState)
    assert host["key"].dtype == np.int64 and host["ref"].dtype == np.float32
    assert host["est"].initialized.dtype == np.bool_
    assert [k for k, _ in t_ckpt._flatten(tree)] == \
        [k for k, _ in _host(_jax_tree())]
