"""The seeded chaos soak of the port's serving path against the JAX
package's, on the CPU.

Checkpoint bit-flip, truncation and torn manifest, save latency, source
stalls and timeouts, two crashes, a SIGTERM, duplicate and late delivery
over a 20-slot soak stream, driven as a process supervisor would (crash ->
fresh runner -> restore -> re-feed from ``t_next``): restore skips the
corrupted generations, nothing is quarantined or gap-filled, the logs
equal JAX's clean run, and the firings and restarts equal the JAX
package's drive of the same seed and schedule.  Firings are compared
ordered by (step, site): the checkpoint writer thread and the serving
thread fire concurrently, so their arrival order in the event log is the
scheduler's (the engine appends under a lock).  Gap and poison sites are
accounted in ``test_torch_ingest.py``."""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)

import harness  # noqa: E402
from repro.ft import chaos as j_chaos  # noqa: E402
from repro.serve import ingest as j_ing  # noqa: E402
from repro.serve import stream as j_stream  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.data.scenarios import (make_chaos_schedule,  # noqa: E402
                                        make_soak_stream)
from repro_torch.ft import chaos as t_chaos  # noqa: E402
from repro_torch.serve import ingest as t_ing  # noqa: E402
from repro_torch.serve.stream import StreamConfig  # noqa: E402
from test_torch_stream import (C, STREAM_KEYS, _jrunner, _logs,  # noqa: E402
                               _runner, weights)

assert weights     # the module-scoped fixture, shared with the stream tests

SOAK_SLOTS = 20     # the shortest stream on which every family fires
WIN = 4


def _drive_chaos(make_runner, ing, trace, live, engine, *, max_restarts=12):
    """A supervised serving loop under chaos (the JAX package's soak loop):
    crash -> fresh runner -> restore -> re-feed from ``t_next``; the
    engine is shared across incarnations (consumed-once faults)."""
    T = len(trace)
    lines = [ing.format_record(t, trace[t], live[t]) for t in range(T)]
    events, restarts = [], 0
    while True:
        r = make_runner()
        r.restore()
        src = ing.ChaosSource(ing.ListSource(lines[r.t_next:], batch=WIN),
                              engine)
        it = ing.StreamIngestor(r, src,
                                ing.IngestConfig(reorder_window=3 * WIN),
                                sleep_fn=lambda s: None)
        try:
            it.pump(until_t=T, flush=True)
            r.saver.wait()
            r.checkpointer.close()
            return r, events + r.events, restarts
        except (j_chaos.ChaosError, t_chaos.ChaosError, SystemExit):
            r.saver.wait()
            r.checkpointer.close()
            events += r.events
            restarts += 1
            assert restarts <= max_restarts


def _firings(engine):
    """The engine's firings without run-local paths, ordered by (step,
    site)."""
    return sorted(({k: v for k, v in e.items() if k != "path"}
                   for e in engine.events),
                  key=lambda e: (e["step"], e["site"], sorted(e.items())))


def test_chaos_soak_equals_clean_run_and_jax(detectors, weights, tmp_path):
    trace, live = make_soak_stream(SOAK_SLOTS, num_cams=C)
    schedule = make_chaos_schedule(SOAK_SLOTS, WIN)
    assert set(schedule) <= t_chaos.RECOVERABLE_SITES
    cfg = dict(window_slots=WIN, queue_slots=4 * WIN, degrade=False,
               install_signal=True)
    graphs = t_fleet.episode_graph_count()
    t_eng = t_chaos.ChaosEngine(7, schedule)
    r, events, restarts = _drive_chaos(
        lambda: _runner(weights, "static", StreamConfig(
            ckpt_dir=str(tmp_path / "port"), **cfg), chaos=t_eng),
        t_ing, trace, live, t_eng)
    j_eng = j_chaos.ChaosEngine(7, schedule)
    jr, _, j_restarts = _drive_chaos(
        lambda: _jrunner(detectors, "static", j_stream.StreamConfig(
            ckpt_dir=str(tmp_path / "jax"), **cfg), chaos=j_eng),
        j_ing, trace, live, j_eng)
    # JAX's clean run: the same windows, no chaos, no checkpoints
    clean = _jrunner(detectors, "static", j_stream.StreamConfig(
        window_slots=WIN, queue_slots=SOAK_SLOTS, degrade=False))
    clean.offer(trace, faults=live)
    clean.serve(flush=True)

    assert restarts == j_restarts >= 3
    assert _firings(t_eng) == _firings(j_eng)
    fired = {s for s, n in t_eng.counts().items() if n}
    assert len({s.split(".")[0] for s in fired}) == 4 and len(fired) >= 6
    skips = [e for e in events if e["kind"] == "restore_skip"]
    assert skips and all("leaf" in e["error"] or "manifest" in e["error"]
                         for e in skips)
    assert t_fleet.episode_graph_count() == graphs
    assert r.quarantined_slots == 0 and r.gap_filled_slots == 0
    assert r.t_next == SOAK_SLOTS and len(r.logs["W"]) == SOAK_SLOTS
    harness.assert_logs_match(_logs(clean), _logs(r), keys=STREAM_KEYS,
                              ctx="chaos soak vs JAX's clean run")
    harness.assert_logs_match(_logs(jr), _logs(r), keys=STREAM_KEYS,
                              ctx="chaos soak vs JAX's chaos soak")
    assert t_ckpt.latest_valid(tmp_path / "port") is not None
