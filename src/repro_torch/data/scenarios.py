"""Scenario matrix: named bandwidth-trace and scene families.

The counterpart of ``repro.data.scenarios``, which is numpy only: the
families below are that module's, verbatim, over the port's
``data/synthetic.py``.

The paper evaluates three FCC-derived bandwidth regimes (section 7.1); real
deployments — and the systems this repro benchmarks against (BiSwift's
competing-stream orchestration, FilterForward's constrained edge links) —
see much uglier regimes: step drops when a competing flow starts, outages,
short spikes, diurnal load curves, and adversarial oscillation around the
allocator's decision boundaries.  This module is the registry the
differential test harness and the benches draw from:

  * **trace families** — ``make_trace(name, num_slots, seed)``: the paper's
    ``fcc_low`` / ``fcc_medium`` / ``fcc_high`` plus ``step_drop``,
    ``outage``, ``spike``, ``diurnal`` and ``adversarial_sawtooth``.  Every
    family is a PURE function of (name, num_slots, seed) — the family name
    folds into the RNG seed through a stable digest (``zlib.crc32``, never
    ``hash``) so traces are identical across interpreter runs — and every
    trace respects the 64 Kbps clip floor the paper's traces use.
  * **scene families** — ``make_scene(name, seed)``: ``SceneConfig``
    variants spanning camera count, object density and motion energy
    (sparse suburbs to rush-hour junctions), again pure in (name, seed).
  * **fault families** — ``make_faults(name, num_slots, num_cams, seed)``:
    per-slot camera liveness masks ``(T, C) bool`` (True = alive) modelling
    camera churn, link flaps and sensor dropouts.  The fleet threads these
    through the episode scan exactly like reducto keep-flags; a dead camera
    reuses the inert-camera contract (zero bits, zero bytes, excluded from
    the allocators).  ``hard_outage`` is the one TRACE family allowed below
    the 64 Kbps floor — its outage window is a true 0 Kbps link.

Keep family functions closed-form over numpy: the harness regenerates them
constantly and cross-process determinism is part of their test contract.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.data.synthetic import (FLOOR_KBPS, SceneConfig,
                                        ar1_trace, bandwidth_trace)


def _rng(name: str, seed: int) -> np.random.Generator:
    """Stable per-(family, seed) generator: the family name enters through
    a crc32 digest, so streams are distinct per family yet reproducible
    across processes (``hash`` is salted by PYTHONHASHSEED)."""
    return np.random.default_rng((int(seed), zlib.crc32(name.encode())))


# -- bandwidth-trace families -------------------------------------------------

def _fcc(kind: str):
    def fam(num_slots: int, seed: int = 0) -> np.ndarray:
        return bandwidth_trace(kind, num_slots, seed=seed)
    fam.__name__ = f"fcc_{kind}"
    fam.__doc__ = f"The paper's FCC-like '{kind}' regime (section 7.1)."
    return fam


def step_drop(num_slots: int, seed: int = 0) -> np.ndarray:
    """Competing-flow step: a high regime that collapses to a low one at a
    seed-chosen slot and stays there (BiSwift's contention onset)."""
    rng = _rng("step_drop", seed)
    t0 = int(rng.integers(1, max(2, num_slots // 2 + 1)))
    mu = np.where(np.arange(num_slots) < t0, 2200.0, 450.0)
    return np.clip(ar1_trace(rng, mu, 180.0, num_slots), FLOOR_KBPS, None)


def outage(num_slots: int, seed: int = 0) -> np.ndarray:
    """Medium regime with a hard outage window clamped to the 64 Kbps floor
    — exercises the infeasibility clamp and elastic debt repayment."""
    rng = _rng("outage", seed)
    x = ar1_trace(rng, 1134.0, 400.0, num_slots)
    t0 = int(rng.integers(0, max(1, num_slots - 1)))
    width = max(1, num_slots // 4)
    x[t0:t0 + width] = 0.0
    return np.clip(x, FLOOR_KBPS, None)


def spike(num_slots: int, seed: int = 0) -> np.ndarray:
    """Starved link with rare huge openings: low base, ~20% of slots jump
    to several Mbps — stresses allocator swings slot-to-slot."""
    rng = _rng("spike", seed)
    x = np.clip(ar1_trace(rng, 400.0, 120.0, num_slots), FLOOR_KBPS, None)
    hits = rng.uniform(size=num_slots) < 0.2
    if not hits.any():
        hits[int(rng.integers(num_slots))] = True
    return np.where(hits, rng.uniform(2500.0, 6000.0, num_slots), x)


def diurnal(num_slots: int, seed: int = 0) -> np.ndarray:
    """Slow sinusoidal load curve between the low and high regimes with
    AR(1) noise on top (a day compressed into the trace length)."""
    rng = _rng("diurnal", seed)
    t = np.arange(num_slots)
    phase = rng.uniform(0, 2 * np.pi)
    mu = 1400.0 + 900.0 * np.sin(2 * np.pi * t / max(num_slots, 2) + phase)
    return np.clip(ar1_trace(rng, mu, 150.0, num_slots), FLOOR_KBPS, None)


def adversarial_sawtooth(num_slots: int, seed: int = 0) -> np.ndarray:
    """Ramp-and-crash oscillation spanning the whole bitrate grid: climbs
    from starvation to abundance over a few slots, then collapses — the
    worst case for any controller with memory (elastic EMA/debt)."""
    rng = _rng("adversarial_sawtooth", seed)
    period = int(rng.integers(3, 6))
    t = np.arange(num_slots)
    ramp = (t % period) / max(period - 1, 1)
    mu = 150.0 + (3200.0 - 150.0) * ramp
    return np.clip(mu + rng.normal(0, 60.0, num_slots), FLOOR_KBPS, None)


def hard_outage(num_slots: int, seed: int = 0) -> np.ndarray:
    """Like ``outage`` but the window is a TRUE 0 Kbps link — the only
    family exempt from the floor clip.  Exercises the allocators' zero-
    capacity path (explicit all-zero infeasible allocation, no bits sent)
    and elastic debt repayment on recovery."""
    rng = _rng("hard_outage", seed)
    x = np.clip(ar1_trace(rng, 1134.0, 400.0, num_slots), FLOOR_KBPS, None)
    t0 = int(rng.integers(0, max(1, num_slots - 1)))
    width = max(1, num_slots // 4)
    x[t0:t0 + width] = 0.0
    return x


TRACE_FAMILIES: Dict[str, Callable[..., np.ndarray]] = {
    "fcc_low": _fcc("low"),
    "fcc_medium": _fcc("medium"),
    "fcc_high": _fcc("high"),
    "step_drop": step_drop,
    "outage": outage,
    "hard_outage": hard_outage,
    "spike": spike,
    "diurnal": diurnal,
    "adversarial_sawtooth": adversarial_sawtooth,
}

# families whose traces may legitimately hit 0 Kbps (fault injection); every
# other family keeps the 64 Kbps floor contract
ZERO_FLOOR_FAMILIES = frozenset({"hard_outage"})

# the paper's traces are sized for its 5-camera deployments; scale shares
# linearly when evaluating other fleet sizes (the convention the test suite
# already uses: ``bandwidth_trace(...) * C / 5``)
TRACE_REFERENCE_CAMS = 5


def trace_families() -> Tuple[str, ...]:
    return tuple(TRACE_FAMILIES)


def make_trace(name: str, num_slots: int, seed: int = 0,
               num_cams: Optional[int] = None) -> np.ndarray:
    """One named bandwidth trace, pure in (name, num_slots, seed).  With
    ``num_cams`` the trace is rescaled from the paper's 5-camera sizing to
    the given fleet size (floor preserved; ``ZERO_FLOOR_FAMILIES`` keep
    their true 0 Kbps slots through the rescale)."""
    fam = TRACE_FAMILIES[name]
    floor = 0.0 if name in ZERO_FLOOR_FAMILIES else FLOOR_KBPS
    x = np.asarray(fam(int(num_slots), seed=int(seed)), np.float64)
    if x.shape != (int(num_slots),) or not np.all(x >= floor - 1e-9):
        # ValueError, not assert (stripped under python -O): a family that
        # forgets the floor clip must not reach the allocator silently
        raise ValueError(f"family {name!r} broke the trace contract: "
                         f"shape {x.shape}, min {x.min() if x.size else None}")
    if num_cams is not None:
        scaled = x * (int(num_cams) / TRACE_REFERENCE_CAMS)
        x = np.where(x <= 0.0, 0.0, np.clip(scaled, FLOOR_KBPS, None))
    return x


# -- scene families -----------------------------------------------------------
#
# Each family fixes the knobs that shape content statistics — camera count,
# object count, motion energy, sensor noise — and leaves the geometry draw
# to the seed.  NOTE for executable reuse: num_cameras / max_objects /
# noise_std participate in the episode program's shapes or statics, so
# families sharing those values share compiled fleet programs; the harness
# groups its cells accordingly.

def _scene(seed: int, **over) -> SceneConfig:
    """A family is a fixed knob set; the geometry draw comes entirely from
    the seed.  Unlike trace families (whose name folds into the RNG via
    ``_rng``), a scene family name carries no RNG stream of its own — two
    families with identical knobs would share geometry by design."""
    return dataclasses.replace(SceneConfig(seed=int(seed)), **over)


SCENE_FAMILIES: Dict[str, Callable[[int], SceneConfig]] = {
    # the default three-camera street scene most tests run
    "urban_mid": lambda seed: _scene(seed, num_cameras=3),
    # sparse traffic, slow movers: motion energy near the keep threshold
    "sparse_suburb": lambda seed: _scene(
        seed, num_cameras=3, max_objects=3, spawn_rate=0.1, mean_speed=1.5),
    # saturated junction: object count at the pool cap, fast crossings
    "dense_junction": lambda seed: _scene(
        seed, num_cameras=3, max_objects=8, spawn_rate=0.9, mean_speed=5.0),
    # night shift: calm motion under heavy sensor noise
    "night_noise": lambda seed: _scene(
        seed, num_cameras=3, mean_speed=1.0, spawn_rate=0.15, noise_std=0.05),
    # minimal two-camera deployment (smallest fleet the allocator sees)
    "cam_pair": lambda seed: _scene(seed, num_cameras=2),
    # wider fleet with energetic motion (exercises camera-axis padding on
    # meshes and the fair-share allocator's granularity)
    "mall_quad": lambda seed: _scene(seed, num_cameras=4, mean_speed=4.0),
}


def scene_families() -> Tuple[str, ...]:
    return tuple(SCENE_FAMILIES)


def make_scene(name: str, seed: int = 0) -> SceneConfig:
    """One named SceneConfig, pure in (name, seed)."""
    return SCENE_FAMILIES[name](int(seed))


# -- fault families -----------------------------------------------------------
#
# Camera liveness masks (T, C) bool, True = alive.  Contract (mirrored by
# ``fleet.fleet_episode``'s docstring): a dead (camera, slot) cell sends zero
# bits and zero bytes, is excluded from the bandwidth allocators, cannot
# advance the reducto reference, and on reconnect is treated as a fresh
# camera (reference re-seeded, elastic debt cleared).  Camera 0 stays alive
# in every family — the fleet requires >= 1 live camera per slot (an all-dead
# slot has no defined control step; model it as a ``hard_outage`` trace
# instead).

def _faults_none(rng, T: int, C: int) -> np.ndarray:
    return np.ones((T, C), bool)


def _faults_dead_camera(rng, T: int, C: int) -> np.ndarray:
    """The LAST camera is dead for the whole trace — the headline
    differential family: logs must equal a (C-1)-camera fleet's."""
    live = np.ones((T, C), bool)
    if C > 1:
        live[:, C - 1] = False
    return live


def _faults_camera_churn(rng, T: int, C: int) -> np.ndarray:
    """Cameras join and leave in contiguous windows (runtime attach/detach):
    each non-anchor camera draws an active [t0, t1) window covering roughly
    half the trace."""
    live = np.zeros((T, C), bool)
    live[:, 0] = True
    for c in range(1, C):
        width = int(rng.integers(max(1, T // 2), T + 1))
        t0 = int(rng.integers(0, T - width + 1))
        live[t0:t0 + width, c] = True
    return live


def _faults_camera_flap(rng, T: int, C: int) -> np.ndarray:
    """One unstable link: a seed-chosen non-anchor camera toggles with a
    short period (worst case for the reconnect path — the reducto reference
    and elastic debt reset every flap)."""
    live = np.ones((T, C), bool)
    if C > 1:
        c = int(rng.integers(1, C))
        period = int(rng.integers(1, 4))
        phase = int(rng.integers(0, period + 1))
        live[:, c] = ((np.arange(T) + phase) // period) % 2 == 0
    return live


def _faults_sensor_corrupt(rng, T: int, C: int) -> np.ndarray:
    """IID per-(slot, camera) segment drops (~15%): a corrupt segment is
    modelled as the camera being absent for that slot (nothing usable was
    captured).  The anchor camera is immune."""
    live = rng.uniform(size=(T, C)) >= 0.15
    live[:, 0] = True
    return live


FAULT_FAMILIES: Dict[str, Callable[..., np.ndarray]] = {
    "none": _faults_none,
    "dead_camera": _faults_dead_camera,
    "camera_churn": _faults_camera_churn,
    "camera_flap": _faults_camera_flap,
    "sensor_corrupt": _faults_sensor_corrupt,
}


def fault_families() -> Tuple[str, ...]:
    return tuple(FAULT_FAMILIES)


# -- serving streams ----------------------------------------------------------

# the canonical soak length: one simulated day of 86.4 s slots at the
# diurnal trace's sinusoid period — the windowed-serving soak test and the
# serve bench both replay this stream (quick lanes truncate it)
SOAK_SLOTS = 1000


def make_soak_stream(num_slots: int = SOAK_SLOTS, num_cams: int = 3,
                     seed: int = 0, fault_family: str = "camera_churn"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The long-horizon serving input: a diurnal bandwidth trace (slow
    low<->high sinusoid — the always-on service's day/night load swing)
    paired with a liveness mask from ``fault_family``.  Pure in every
    argument, so a killed-and-restarted serving process can regenerate the
    exact stream and replay from any slot offset."""
    trace = make_trace("diurnal", num_slots, seed=seed, num_cams=num_cams)
    live = make_faults(fault_family, num_slots, num_cams, seed=seed)
    return trace, live


def make_faults(name: str, num_slots: int, num_cams: int,
                seed: int = 0) -> np.ndarray:
    """One named liveness mask, pure in (name, num_slots, num_cams, seed).

    Returns ``(num_slots, num_cams) bool`` with True = alive; every slot
    keeps at least one live camera (validated, like ``make_trace``'s floor
    contract — a family that starves a slot must not reach the fleet
    silently)."""
    T, C = int(num_slots), int(num_cams)
    live = np.asarray(FAULT_FAMILIES[name](_rng("faults_" + name, seed),
                                           T, C))
    if live.dtype != np.bool_ or live.shape != (T, C) \
            or not np.all(live.any(axis=1)):
        raise ValueError(f"fault family {name!r} broke the liveness "
                         f"contract: dtype {live.dtype}, shape {live.shape}")
    return live


# -- chaos schedules ----------------------------------------------------------

def make_chaos_schedule(num_slots: int, window_slots: int = 8, seed: int = 0,
                        poisoned: bool = False) -> Dict[str, Dict]:
    """The canonical chaos-soak schedule, pure in every argument (plain
    dicts — ``ft.chaos.SiteSpec.of`` accepts them; data/ stays below ft/ in
    the layering).  Scales its fault positions to the stream: windows are
    ``num_slots // window_slots`` and each crash/corruption pair lands at a
    distinct window fraction.

    The default (``poisoned=False``) schedule uses only VALUE-PRESERVING
    recoverable sites — 8 families spanning checkpoint corruption, save
    latency, source stalls/timeouts, mid-window crashes, and
    duplicate/out-of-order delivery — so a chaos run's concatenated logs
    must match the fault-free run <= 1e-5 (the headline differential).
    Corruption/crash pairing: ``ckpt.bitflip`` (and ``ckpt.torn_manifest``)
    corrupt the generation committed at save-step w, and ``serve.exception``
    crashes at window w BEFORE any newer save — restore must demonstrably
    skip the corrupted latest generation and fall back.

    ``poisoned=True`` adds the four accounting-only sites (``ingest.gap`` /
    ``nan`` / ``negative`` / ``absurd``): those slots gap-fill by declared
    policy, so logs diverge by design and the contract becomes exact
    quarantine/gap accounting + finite logs (12 families total)."""
    T = int(num_slots)
    W = max(4, T // int(window_slots))
    w1 = max(1, W // 4)              # bitflip + exception (fallback demo)
    w2 = max(w1 + 1, W // 2)         # truncate (healed by the next save)
    w3 = max(w2 + 1, (3 * W) // 4)   # torn manifest + exception
    w4 = max(w3 + 1, W - 1)          # SIGTERM (preemption save path)
    rng = _rng("chaos_schedule", seed)
    # one DISJOINT slot pool split across the delivery/value sites: a slot
    # hit by two ingest faults at once would make the per-site accounting
    # the chaos tests assert ("quarantined slots accounted exactly")
    # ambiguous
    per = max(2, T // 100)
    pool = rng.choice(T, size=min(T, per * 6), replace=False)
    dup, oo = pool[:per], pool[per:2 * per]
    sched: Dict[str, Dict] = {
        "ckpt.bitflip": {"at": [w1]},
        "ckpt.truncate": {"at": [w2]},
        "ckpt.torn_manifest": {"at": [w3]},
        "ckpt.save_latency": {"at": [max(1, w1 - 1)], "mag": 0.01},
        # early poll ordinals: they must land before the first crash so
        # every family fires even on the shortest (48-slot) soak
        "source.stall": {"at": [3]},
        "source.timeout": {"at": [2]},
        "serve.exception": {"at": [w1, w3]},
        "serve.sigterm": {"at": [w4]},
        "ingest.duplicate": {"at": sorted(int(t) for t in dup)},
        "ingest.reorder": {"at": sorted(int(t) for t in oo)},
    }
    if poisoned:
        q = np.array_split(pool[2 * per:], 4)
        sched.update({
            "ingest.gap": {"at": sorted(int(t) for t in q[0])},
            "ingest.nan": {"at": sorted(int(t) for t in q[1])},
            "ingest.negative": {"at": sorted(int(t) for t in q[2])},
            "ingest.absurd": {"at": sorted(int(t) for t in q[3])},
        })
    return sched
