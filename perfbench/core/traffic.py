"""Traffic generators of the benchmark: bandwidth traces and camera
liveness, read from a traffic file's parameters.

Copies of the port's numpy generators (``data/synthetic.py``'s FCC AR(1)
traces and ``data/scenarios.py``'s trace families, fault families and the
soak stream), kept here so that a change to the program cannot move the
traffic it is measured on.  Every generator is pure in its arguments.
"""
from __future__ import annotations

import zlib
from typing import Callable, Dict, Tuple

import numpy as np

# the paper's FCC regime parameters (mean, std) in Kbps (section 7.1) and
# the clip floor its traces respect
FCC_PARAMS = {"low": (521.0, 230.0), "medium": (1134.0, 499.0),
              "high": (2305.0, 1397.0)}
FLOOR_KBPS = 64.0


def ar1_trace(rng: np.random.Generator, mu, sd: float, num_slots: int,
              rho: float = 0.8) -> np.ndarray:
    """AR(1) around a (scalar or per-slot) mean; innovations are drawn
    first, then x[0] (the JAX package's draw order)."""
    mu = np.broadcast_to(np.asarray(mu, np.float64), (num_slots,))
    eps = rng.normal(0, sd * np.sqrt(1 - rho ** 2), num_slots)
    x = np.empty(num_slots)
    x[0] = mu[0] + rng.normal(0, sd)
    for t in range(1, num_slots):
        x[t] = mu[t] + rho * (x[t - 1] - mu[t]) + eps[t]
    return x


def bandwidth_trace(kind: str, num_slots: int, seed: int = 0) -> np.ndarray:
    """FCC-like AR(1) trace with the paper's means/stds, clipped at the
    64 Kbps floor; the kind folds into the seed through ``zlib.crc32``."""
    mu, sd = FCC_PARAMS[kind]
    rng = np.random.default_rng(seed + zlib.crc32(kind.encode()) % 1000)
    return np.clip(ar1_trace(rng, mu, sd, num_slots), FLOOR_KBPS, None)


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


# -- serving streams ----------------------------------------------------------

def make_soak_stream(num_slots: int, num_cams: int = 3, seed: int = 0,
                     fault_family: str = "camera_churn",
                     trace_family: str = "diurnal"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The long-horizon serving input: a bandwidth trace (by default the
    diurnal low<->high sinusoid) paired with a liveness mask from
    ``fault_family``, pure in every argument."""
    trace = make_trace(trace_family, num_slots, seed=seed, num_cams=num_cams)
    live = make_faults(fault_family, num_slots, num_cams, seed=seed)
    return trace, live


def make_stream(traffic: Dict, num_cams: int, seed: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A traffic file's stream: (bandwidth (L,) Kbps, liveness (L, C) bool)
    for ``generator`` "soak_stream" (a trace family paired with a fault
    family, the serving launcher's soak stream), ``day_slots`` long."""
    gen = traffic["generator"]
    if gen != "soak_stream":
        raise ValueError(f"unknown traffic generator {gen!r}")
    return make_soak_stream(int(traffic["day_slots"]), num_cams=num_cams,
                            seed=seed,
                            trace_family=traffic.get("trace_family",
                                                     "diurnal"),
                            fault_family=traffic.get("fault_family",
                                                     "camera_churn"))
