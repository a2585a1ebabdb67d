"""Crash-safe continuous serving: the always-on windowed stream runner.

The counterpart of ``repro.serve.stream``.  ``StreamingFleetRunner`` serves
an unbounded bandwidth/liveness stream through the episodes a
``DeepStreamSystem`` already runs as CUDA graphs:

  * **Windows.**  Incoming slots queue in a bounded buffer
    (``StreamConfig.queue_slots``; overflow is dropped and counted in
    ``dropped_slots``).  Each full window (``window_slots``, sized to an
    episode bucket) runs as one episode, replaying the graphs captured for
    its (method, configuration, bucket): serving captures nothing new.
  * **Carry.**  The episode carry (``scheduler.EpisodeCarry``: the elastic
    state and the reducto reference on the device, the previous liveness
    row and the stream's first slot on the host) hands across window
    boundaries, so the windowed stream is slot for slot one episode over
    the concatenated trace.  The codec keys are a pure fold of the run key
    and the scene is pure in (seed, cursor), so both continue across
    windows and across restarts.
  * **Checkpoints.**  At each window boundary the carry and the run key
    are snapshot in one device-to-host transfer and written, with the host
    counters and logs as metadata, by ``ckpt.AsyncSaver`` on a writer
    thread (atomic commit, per-leaf checksums; ``ckpt_keep`` bounds
    retention without deleting the newest valid generation).  The format is
    the JAX package's: either package's runner restores the other's
    checkpoint.  ``restore`` falls back past corrupt generations to the
    newest that verifies; a ``ft.PreemptionCheckpointer`` turns
    SIGTERM/SIGINT into save-now-and-exit.
  * **SLO supervision.**  An ``ft.Watchdog`` over window turnaround drives
    the ladder ``episode`` -> ``episode_small`` (the window in chunks of
    the next-smaller bucket, the carry chained through them) ->
    ``pipelined`` (the fleet slot loop seeded from the carry) and climbs
    back after ``recover_after`` healthy windows.  Every rung serves the
    same carry chain, so a rung change moves latency, never the logs.

Per window the host waits on the card at the episode's harvest and, when
the window checkpoints, once more for the snapshot; under a camera mesh
also at the two agreements; nothing else.

Under a camera mesh (the system's, ``sharding.rules``) every rank runs
the same runner over its rows of the fleet and holds the same logs.  The
checkpoint holds the whole fleet's (C, H, W) reducto reference, as the
JAX package's does: the ranks gather it at the window boundary and rank 0
alone writes.  Every rank restores from the files, at any world size or
with no mesh, and takes its rows.  Each rung and each checkpoint issues
its own collectives, so every rank must take the same branch: the ranks
agree (``rules.agree``, one MAX all-reduce) before each window on whether
a fault hook failed on any rank (then every rank raises and restores),
and after it on the slowest rank's turnaround, which the watchdog reads,
and on any rank's preemption flag, which ``maybe_save`` reads.  A signal
that lands after the agreement is taken at the next boundary.

Window lifecycle::

    offer(slots) -> [bounded queue] -> serve():
        per window:  dispatch(rung, carry)      # episode graphs / chunks
                     carry = system.last_carry
                     logs += window logs         # the harvest
                     verdict = watchdog.record(wall)
                     checkpointer.maybe_save(window)   # snapshot + async
    crash / SIGTERM -> restore():
        newest valid generation -> carry + key + counters + logs
        scene cursor = t_next; the caller re-offers from t_next
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.common import trace
from repro_torch.core import elastic as elastic_mod
from repro_torch.core import fleet as fleet_mod
from repro_torch.core.scheduler import DeepStreamSystem, EpisodeCarry
from repro_torch.data.synthetic import DeviceScene
from repro_torch.sharding import rules
from repro_torch.ft.watchdog import (PreemptionCheckpointer, Watchdog,
                                     WatchdogConfig)

LOG_KEYS = ("utility", "mean_f1", "bytes", "W", "extra", "area",
            "alloc_kbps")

# the degraded-mode ladder: every rung serves the same carry chain
LADDER = ("episode", "episode_small", "pipelined")


@dataclass
class StreamConfig:
    """Serving policy of ``StreamingFleetRunner``: ``window_slots`` (an
    episode bucket, else bucketed up), ``queue_slots`` (the bounded ingest
    buffer), ``ckpt_dir`` (None: no checkpoints), ``ckpt_every`` (in
    windows), ``ckpt_keep`` (retention, never the newest valid
    generation; None keeps all), ``install_signal`` (SIGTERM/SIGINT ->
    save now and exit), ``recover_after`` (healthy windows per rung
    climbed back)."""
    window_slots: int = 8
    queue_slots: int = 64
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    ckpt_keep: Optional[int] = None
    degrade: bool = True
    recover_after: int = 3
    install_signal: bool = False
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)


class StreamingFleetRunner:
    """Always-on windowed serving over a ``DeepStreamSystem``'s episodes
    (see the module docstring).

    ``wall_hook(window, wall_s) -> wall_s`` rewrites a window's measured
    turnaround before the watchdog sees it (tests inject stragglers);
    ``fault_hook(window=, rung=)`` runs before each window's dispatch and
    may raise (tests inject crashes); ``chaos`` is an optional
    ``ft.chaos.ChaosEngine`` whose ``pre_window`` fires before each window
    and whose checkpoint sites thread into the saver."""

    def __init__(self, system: DeepStreamSystem, scene: DeviceScene,
                 method: str = "deepstream",
                 cfg: Optional[StreamConfig] = None,
                 use_elastic: Optional[bool] = None,
                 wall_hook: Optional[Callable[[int, float], float]] = None,
                 fault_hook: Optional[Callable[..., None]] = None,
                 chaos: Optional[Any] = None):
        cfg = cfg if cfg is not None else StreamConfig()
        if not system.cfg.episode:
            raise ValueError("StreamingFleetRunner needs an episode-mode "
                             "system (SystemConfig.episode=True)")
        if system.cfg.w_cap_kbps is None:
            # the DP capacity is part of the episode graph's key: a
            # capacity per window would capture new graphs as the
            # bandwidth swings
            raise ValueError("streaming requires SystemConfig.w_cap_kbps "
                             "pinned (per-window capacities would capture "
                             "new episode graphs)")
        if not isinstance(scene, DeviceScene):
            raise TypeError("streaming serves a DeviceScene (device-side "
                            f"segment generation), got {type(scene)!r}")
        self.system = system
        self.scene = scene
        self.method = method
        self.cfg = cfg
        self.use_elastic = (method == "deepstream" if use_elastic is None
                            else use_elastic)
        self.wall_hook = wall_hook
        self.fault_hook = fault_hook
        self.chaos = chaos
        self._C = system.cfg.scene.num_cameras
        self.carry: Optional[EpisodeCarry] = None
        self.window = 0                      # completed windows
        self.dropped_slots = 0               # queue overflow
        self.rung = 0                        # ladder position
        self.ok_streak = 0                   # consecutive healthy windows
        # ingest accounting (``serve.ingest`` calls ``note_ingest``),
        # checkpointed with the carry
        self.quarantined: Dict[str, int] = {}
        self.quarantined_slots = 0
        self.gap_filled_slots = 0
        self.duplicates = 0
        self.out_of_order = 0
        self.logs: Dict[str, List[float]] = {k: [] for k in LOG_KEYS}
        # turnaround per served window (span ``stream.turnaround``) and
        # seconds per successful restore (span ``stream.restore``)
        self.window_walls: List[float] = []
        self.restore_s: List[float] = []
        self.events: List[Dict[str, Any]] = []
        self._queue: Deque[Tuple[float, np.ndarray]] = deque()
        self.watchdog = Watchdog(cfg.watchdog)
        self.saver = ckpt.AsyncSaver(keep=cfg.ckpt_keep, chaos=chaos)
        self.checkpointer = PreemptionCheckpointer(
            self._checkpoint, every=max(1, cfg.ckpt_every),
            install_signal=cfg.install_signal)

    # -- ingest ----------------------------------------------------------------

    @property
    def t_next(self) -> int:
        """The next global slot this runner serves: where a restarted
        feeder resumes."""
        return self.scene._t

    def queued_slots(self) -> int:
        return len(self._queue)

    def note_ingest(self, kind: str, **info: Any) -> None:
        """The ingest stage's accounting hook: bumps the counters and
        appends an event (the runner's event log is the one serving
        record)."""
        if kind == "quarantine":
            reason = str(info.get("reason", "unknown"))
            self.quarantined[reason] = self.quarantined.get(reason, 0) + 1
            self.quarantined_slots += 1
        elif kind == "gap_fill":
            self.gap_filled_slots += 1
        elif kind == "duplicate":
            self.duplicates += 1
        elif kind == "out_of_order":
            self.out_of_order += 1
        self.events.append({"kind": kind, **info})

    def offer(self, trace_kbps: np.ndarray,
              faults: Optional[np.ndarray] = None) -> int:
        """Enqueue slots; returns how many were accepted.  Slots past the
        queue's free space are dropped and counted.  Non-finite or negative
        bandwidth is refused (ValueError) before anything reaches the
        device: untrusted input goes through ``serve.ingest``.  Span
        ``stream.offer``, of the window it feeds."""
        with trace.span("stream.offer", window=self.window + 1):
            W = np.asarray(trace_kbps, np.float64).reshape(-1)
            if W.size and (not np.all(np.isfinite(W)) or np.any(W < 0.0)):
                raise ValueError("offer() requires finite, non-negative "
                                 "bandwidth; route untrusted input through "
                                 "serve.ingest.StreamIngestor")
            T = len(W)
            if faults is None:
                live = np.ones((T, self._C), bool)
            else:
                live = np.asarray(faults, bool)
                if live.shape != (T, self._C):
                    raise ValueError(f"faults mask must be (T={T}, "
                                     f"C={self._C}), got {live.shape}")
            room = max(0, self.cfg.queue_slots - len(self._queue))
            take = min(room, T)
            for i in range(take):
                self._queue.append((float(W[i]), live[i]))
            if take < T:
                self.dropped_slots += T - take
                self.events.append({"kind": "drop", "slots": T - take,
                                    "queued": len(self._queue)})
            return take

    # -- serving ---------------------------------------------------------------

    def serve(self, flush: bool = False) -> int:
        """Serve every full window queued (with ``flush``, one last partial
        window too).  Returns the windows served.  May raise
        ``SystemExit`` after a preemption save, or whatever ``fault_hook``
        raises: ``restore`` recovers either."""
        served = 0
        while len(self._queue) >= self.cfg.window_slots:
            self._serve_window(self.cfg.window_slots)
            served += 1
        if flush and self._queue:
            self._serve_window(len(self._queue))
            served += 1
        return served

    def _take(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        W = np.empty(n, np.float64)
        live = np.empty((n, self._C), bool)
        for i in range(n):
            W[i], live[i] = self._queue.popleft()
        return W, live

    def _serve_window(self, n: int) -> None:
        """One window under the root span ``stream.window`` (its id: the
        window count once it is served, the checkpoint's step):
        ``stream.take``, ``stream.turnaround`` (the watchdog's wall:
        ``stream.pre_window`` and the episodes), ``stream.supervise`` and
        ``stream.checkpoint``."""
        with trace.span("stream.window", window=self.window + 1):
            with trace.span("stream.take"):
                W, live = self._take(n)
            mesh = self.system.mesh
            with trace.timer("stream.turnaround") as turn:
                self._pre_window()
                logs = self._dispatch_window(W, live)
            wall = turn.seconds
            if self.wall_hook is not None:
                wall = self.wall_hook(self.window, wall)
            preempted = None
            if mesh is not None:
                # the slowest rank's turnaround and any rank's preemption,
                # read once: every rank takes the same rung and saves alike
                _, (wall, flag) = rules.agree(
                    None, (wall, self.checkpointer.preempted), mesh,
                    self.system.device)
                wall, preempted = float(wall), bool(flag)
                if preempted:
                    self.checkpointer.preempted = True
            self.carry = self.system.last_carry
            for k in LOG_KEYS:
                self.logs[k].extend(float(v) for v in logs[k])
            self.window += 1
            self.window_walls.append(wall)
            with trace.span("stream.supervise"):
                self._supervise(wall)
            if self.cfg.ckpt_dir is not None:
                with trace.span("stream.checkpoint"):
                    self.checkpointer.maybe_save(self.window,
                                                 preempted=preempted)

    def _pre_window(self) -> None:
        """The window's fault hooks (span ``stream.pre_window``).  Under a
        camera mesh a hook that raises on one rank raises on every rank
        (the others a RuntimeError naming it) before any collective of
        the window, so the ranks crash, and restore, together."""
        with trace.span("stream.pre_window"):
            mesh = self.system.mesh
            err = None
            try:
                if self.fault_hook is not None:
                    self.fault_hook(window=self.window, rung=self.rung)
                if self.chaos is not None:
                    # consumed-once: a recovered runner re-serving this
                    # window does not crash again
                    self.chaos.pre_window(self.window)
            except Exception as e:
                if mesh is None:
                    raise
                err = e
            if mesh is not None:
                err, _ = rules.agree(err, (), mesh, self.system.device)
                if err is not None:
                    raise err

    def _dispatch_window(self, W: np.ndarray, live: np.ndarray
                         ) -> Dict[str, np.ndarray]:
        """One window at the current rung; every rung threads the same
        carry chain."""
        mode = LADDER[self.rung]
        if mode == "pipelined":
            return self.system._run_batched(
                self.scene, W, self.method, self.use_elastic, faults=live,
                carry=self.carry)
        step = len(W) if mode == "episode" else self._small_len()
        parts = []
        for i0 in range(0, len(W), step):
            i1 = min(i0 + step, len(W))
            parts.append(self.system.run_episode(
                self.scene, W[i0:i1], self.method, self.use_elastic,
                faults=live[i0:i1], carry=self.carry))
            self.carry = self.system.last_carry
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def _small_len(self) -> int:
        """The degraded chunk: the episode bucket below the window's,
        floored at the smallest."""
        buckets = sorted(self.system.cfg.episode_buckets or
                         (self.cfg.window_slots,))
        wb = fleet_mod.bucket_len(self.cfg.window_slots, buckets)
        below = [b for b in buckets if b < wb]
        return below[-1] if below else buckets[0]

    def _supervise(self, wall: float) -> None:
        """The SLO ladder: 'replace' degrades one rung, ``recover_after``
        consecutive 'ok' windows climb one back; both rebaseline the
        watchdog."""
        verdict = self.watchdog.record(self.window, wall)
        self.events.append({"kind": "window", "window": self.window,
                            "rung": LADDER[self.rung], "wall_s": wall,
                            "verdict": verdict})
        if (verdict == "replace" and self.cfg.degrade
                and self.rung + 1 < len(LADDER)):
            self.rung += 1
            self.ok_streak = 0
            self.watchdog.rebaseline()
            self.events.append({"kind": "degrade", "to": LADDER[self.rung],
                                "window": self.window})
        elif verdict == "ok" and self.rung > 0:
            self.ok_streak += 1
            if self.ok_streak >= self.cfg.recover_after:
                self.rung -= 1
                self.ok_streak = 0
                self.watchdog.rebaseline()
                self.events.append({"kind": "recover",
                                    "to": LADDER[self.rung],
                                    "window": self.window})
        elif verdict != "ok":
            self.ok_streak = 0

    # -- checkpoint / restore --------------------------------------------------

    def _carry_tree(self) -> Dict[str, Any]:
        """The checkpointed tree under the JAX package's leaf names: the
        carry and the codec run key (the rest is host metadata, or pure).
        The reference is the whole fleet's (C, H, W): under a camera mesh
        it is gathered from every rank (a collective)."""
        c = self.carry
        mesh = self.system.mesh
        ref = (c.ref if mesh is None
               else rules.gather(c.ref, mesh)[:self._C])
        return {"est": c.est, "ref": ref,
                "live_prev": np.asarray(c.live_prev, bool),
                "key": self.system._key}

    def _carry_target(self) -> Dict[str, Any]:
        """A zero carry of the checkpoint's structure, on the system's
        device (the run key int64, as the port keeps it)."""
        scfg = self.system.cfg.scene
        dev = self.system.device
        return {"est": elastic_mod.init_state(dev),
                "ref": torch.zeros((self._C, scfg.height, scfg.width),
                                   dtype=torch.float32, device=dev),
                "live_prev": np.ones((self._C,), bool),
                "key": torch.zeros_like(self.system._key)}

    def _ckpt_path(self, window: int) -> Path:
        return Path(self.cfg.ckpt_dir) / f"window_{window:08d}"

    def _checkpoint(self, window: int) -> None:
        """The carry's checkpoint at a window boundary: one snapshot on
        this thread, then an async write (blocking when preempted: the
        process is about to exit).  Under a camera mesh every rank takes
        part in the gather and rank 0 alone writes."""
        if self.carry is None:
            return
        tree = self._carry_tree()
        if not rules.is_writer(self.system.mesh):
            return
        with trace.span("ckpt.meta"):
            meta = {"window": window, "t_next": int(self.t_next),
                    "t_first": int(self.carry.t_first), "rung": self.rung,
                    "ok_streak": self.ok_streak,
                    "dropped_slots": self.dropped_slots,
                    "method": self.method,
                    "quarantined": dict(self.quarantined),
                    "quarantined_slots": self.quarantined_slots,
                    "gap_filled_slots": self.gap_filled_slots,
                    "duplicates": self.duplicates,
                    "out_of_order": self.out_of_order,
                    "logs": {k: list(v) for k, v in self.logs.items()}}
        # the file holds the run key as the JAX package does: uint32
        self.saver.save(tree, self._ckpt_path(window),
                        step=window, metadata=meta,
                        blocking=self.checkpointer.preempted,
                        dtypes={"['key']": np.uint32})

    def restore(self) -> bool:
        """Restore from the newest valid committed checkpoint under
        ``ckpt_dir`` (False if there is none: a fresh start).  A corrupt
        generation is skipped with a ``restore_skip`` event naming what
        failed.  Rebuilds the carry, the run key, the scene cursor, the
        logs, the counters and the rung; the caller re-offers the stream
        from ``t_next``.  The restored carry re-enters the graphs the
        process already captured.  Under a camera mesh each rank reads the
        files and takes its rows of the reference, whatever world wrote
        them."""
        if self.cfg.ckpt_dir is None:
            return False
        with trace.timer("stream.restore") as tm:
            ok = self._restore()
        if ok:
            self.restore_s.append(tm.seconds)
        return ok

    def _restore(self) -> bool:
        tree = meta = path = None
        for cand in reversed(ckpt.generations(self.cfg.ckpt_dir)):
            try:
                tree, meta = ckpt.restore(cand, self._carry_target())
                path = cand
                break
            except ckpt.CheckpointCorruptError as e:
                self.events.append({"kind": "restore_skip",
                                    "path": str(cand), "error": str(e)})
        if path is None:
            return False
        self.system._key = tree["key"]
        self.carry = EpisodeCarry(
            est=tree["est"],
            ref=rules.scatter(tree["ref"], self.system.mesh, 0.0),
            live_prev=np.asarray(tree["live_prev"], bool),
            t_first=int(meta["t_first"]))
        self.scene._t = int(meta["t_next"])
        self.window = int(meta["window"])
        self.rung = int(meta["rung"])
        self.ok_streak = int(meta["ok_streak"])
        self.dropped_slots = int(meta["dropped_slots"])
        self.quarantined = {str(k): int(v) for k, v in
                            meta.get("quarantined", {}).items()}
        self.quarantined_slots = int(meta.get("quarantined_slots", 0))
        self.gap_filled_slots = int(meta.get("gap_filled_slots", 0))
        self.duplicates = int(meta.get("duplicates", 0))
        self.out_of_order = int(meta.get("out_of_order", 0))
        self.logs = {k: [float(v) for v in meta["logs"].get(k, [])]
                     for k in LOG_KEYS}
        self.checkpointer.last_saved = self.window
        self.events.append({"kind": "restore", "path": str(path),
                            "window": self.window, "t_next": self.t_next})
        return True

    # -- stats / teardown ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Serving summary over the windows served so far (the JAX
        package's keys, plus the checkpoint's costs in ms: the snapshot on
        the serving thread, the writer's commit, and a restore)."""
        walls = np.asarray(self.window_walls, float)
        slots = len(self.logs["W"])
        total = float(walls.sum()) if walls.size else 0.0
        mean_ms = lambda xs: 1e3 * float(np.mean(xs)) if xs else 0.0
        return {
            "windows": int(walls.size),
            "slots": slots,
            "dropped_slots": self.dropped_slots,
            "quarantined_slots": self.quarantined_slots,
            "gap_filled_slots": self.gap_filled_slots,
            "duplicates": self.duplicates,
            "out_of_order": self.out_of_order,
            "p50_window_s": float(np.percentile(walls, 50)) if walls.size else 0.0,
            "p99_window_s": float(np.percentile(walls, 99)) if walls.size else 0.0,
            "slots_per_s": slots / total if total > 0 else 0.0,
            "rung": LADDER[self.rung],
            "ckpt_snapshot_ms": mean_ms(self.saver.snapshot_s),
            "ckpt_write_ms": mean_ms(self.saver.write_s),
            "restore_ms": mean_ms(self.restore_s),
        }

    def close(self) -> None:
        """Flush the checkpoint write in flight and restore the process's
        signal handlers."""
        self.saver.wait()
        self.checkpointer.close()

    def __enter__(self) -> "StreamingFleetRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
