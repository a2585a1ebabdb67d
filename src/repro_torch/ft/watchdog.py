"""Straggler / failure detection and the preemption-aware checkpoint policy.

The counterpart of ``repro.ft.watchdog`` (numpy and the standard library
only, copied so that the port imports nothing of the JAX package).  The
detector reuses the statistical machinery of the paper's elastic
thresholds (EMA + sigma gating, section 5.3.1a): a step-time EWMA with
variance tracking flags steps slower than ema + gamma*sigma as straggler
events; sustained violations escalate to ``replace``.  The serving loop
(``serve.stream``) and ``core.scheduler.EpisodeSupervisor`` feed it
window and run wall times and walk their degraded-mode ladders on its
verdicts.  A ``SimulatedFleet`` drives tests without hardware.

Also here: the preemption-aware checkpoint policy (save every N steps,
save NOW on SIGTERM/SIGINT).
"""
from __future__ import annotations

import signal
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class WatchdogConfig:
    alpha: float = 0.1            # EWMA factor (same form as elastic tau_a)
    gamma: float = 3.0            # sigma multiplier for the straggler gate
    warmup_steps: int = 5         # ignore compile/first-step outliers
    escalate_after: int = 3       # consecutive violations -> "replace"


@dataclass
class StepStats:
    ema: float = 0.0
    var: float = 0.0
    count: int = 0
    violations: int = 0
    events: List[Dict] = field(default_factory=list)


class Watchdog:
    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self.stats = StepStats()

    def rebaseline(self) -> None:
        """Forget the EMA/variance baseline (fresh warmup) but KEEP the
        event log.  Call on a mode change: after a supervisor degrades (or
        recovers) the step-time distribution shifts wholesale, and gating
        the new mode's first steps against the old mode's baseline either
        mis-flags every step (degrade to a slower rung) or masks real
        stragglers (recover to a faster one)."""
        events = self.stats.events
        self.stats = StepStats(events=events)

    def record(self, step: int, step_time: float) -> str:
        """Returns 'ok' | 'straggler' | 'replace'."""
        s, c = self.stats, self.cfg
        s.count += 1
        if s.count <= c.warmup_steps:
            if s.count == 1:
                s.ema = step_time
            else:
                s.ema = s.ema + c.alpha * (step_time - s.ema)
            return "ok"
        sigma = float(np.sqrt(max(s.var, 1e-12)))
        threshold = s.ema + c.gamma * max(sigma, 0.05 * s.ema)
        status = "ok"
        if step_time > threshold:
            s.violations += 1
            status = "replace" if s.violations >= c.escalate_after else "straggler"
            s.events.append({"step": step, "t": step_time,
                             "threshold": threshold, "status": status})
        else:
            s.violations = 0
            # only healthy steps update the baseline (else stragglers poison it)
            delta = step_time - s.ema
            s.ema += c.alpha * delta
            s.var = (1 - c.alpha) * (s.var + c.alpha * delta * delta)
        return status


class PreemptionCheckpointer:
    """Save every N steps + immediately on SIGTERM/SIGINT (spot/preemption
    notice).  The previously installed handlers are CHAINED, not discarded
    — stacking a second checkpointer (or running under a framework that
    installed its own handler) keeps everyone's handler live — and restored
    on ``close()`` / ``__exit__``, so a finished checkpointer leaves the
    process's signal disposition exactly as it found it."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, save_fn: Callable[[int], None], every: int = 100,
                 install_signal: bool = True):
        self.save_fn = save_fn
        self.every = every
        self.preempted = False
        self.preempt_signum: Optional[int] = None
        self.last_saved = -1
        self._prev_handlers: Dict[int, object] = {}
        if install_signal:
            for sig in self.SIGNALS:
                try:
                    self._prev_handlers[sig] = signal.signal(
                        sig, self._on_signal)
                except ValueError:
                    pass  # not on main thread (tests)

    def _on_signal(self, signum, frame):
        self.preempted = True
        self.preempt_signum = signum
        prev = self._prev_handlers.get(signum)
        # chain a real previous handler: SIG_DFL/SIG_IGN/None are not
        # callables, and Python's default SIGINT handler would raise
        # KeyboardInterrupt right here — displacing it is the point
        if callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def close(self) -> None:
        """Restore the signal handlers this checkpointer displaced."""
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}

    def __enter__(self) -> "PreemptionCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def maybe_save(self, step: int, preempted: Optional[bool] = None
                   ) -> bool:
        """Save at every ``every``-th step and, when preempted, save now
        and exit.  ``preempted`` (default: the signal's flag as it reads
        now) lets a caller decide on a flag read once and agreed with
        other processes: a signal landing after that read waits for the
        next step."""
        if preempted is None:
            preempted = self.preempted
        if preempted or (step % self.every == 0 and step != self.last_saved):
            self.save_fn(step)
            self.last_saved = step
            if preempted:
                # conventional 128+signum exit status (143 for SIGTERM)
                raise SystemExit(128 + (self.preempt_signum
                                        or signal.SIGTERM))
            return True
        return False


class SimulatedFleet:
    """Test harness: N workers with injectable slow/dead nodes."""

    def __init__(self, n: int, base_step_time: float = 0.1, seed: int = 0):
        self.n = n
        self.base = base_step_time
        self.rng = np.random.default_rng(seed)
        self.slow: Dict[int, float] = {}
        self.dead: set = set()

    def inject_straggler(self, worker: int, factor: float = 5.0) -> None:
        self.slow[worker] = factor

    def kill(self, worker: int) -> None:
        self.dead.add(worker)

    def step_times(self) -> np.ndarray:
        t = self.base * (1 + 0.05 * self.rng.standard_normal(self.n))
        for w, f in self.slow.items():
            t[w] *= f
        for w in self.dead:
            t[w] = np.inf
        return t

    def synchronous_step_time(self) -> float:
        """SPMD training runs at the speed of the slowest live worker."""
        return float(np.max(self.step_times()))
