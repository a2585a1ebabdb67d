"""Deterministic, seeded chaos engine for the serving stack.

The counterpart of ``repro.ft.chaos`` (numpy and the standard library
only, copied so that the port imports nothing of the JAX package;
``fold_rng`` draws the same numbers as the JAX package's).

Robustness claims are only as strong as the fault schedule that tested
them, and a fault schedule is only debuggable if it REPLAYS: a chaos run
here is a pure function of ``(seed, schedule)`` — rerun the same program
with the same pair and every fault fires at the same step with the same
parameters (which byte flipped, how long the stall lasted).  Nothing in
this module draws from global RNG state or the wall clock.

**Fault model — the injection-site registry** (``SITES``; a schedule may
only name registered sites, typos fail fast):

=====================  ========================================================
site                   effect (and who consults it)
=====================  ========================================================
``ckpt.bitflip``       flip one byte of a committed checkpoint's ``data.bin``
                       (``AsyncSaver`` post-commit hook) — RECOVERABLE: restore
                       detects the per-leaf checksum mismatch and falls back a
                       generation
``ckpt.truncate``      truncate ``data.bin`` (post-commit) — recoverable, as
                       above (leaf read runs past EOF)
``ckpt.torn_manifest`` truncate ``manifest.json`` mid-document (post-commit) —
                       recoverable (manifest fails to parse, generation falls
                       back)
``ckpt.save_latency``  sleep inside the checkpoint writer (pre-write) — the
                       async saver absorbs it off the serving path; only a
                       preemption-triggered BLOCKING save feels it
``source.stall``       an ingest source poll returns nothing (keyed by poll
                       ordinal) — recoverable: the ingest loop backs off
                       exponentially and retries
``source.timeout``     an ingest source poll times out
                       (``serve.ingest.SourceTimeout``) — recoverable:
                       retried like a stall
``serve.exception``    raise ``ChaosError`` right before a window dispatches —
                       recoverable: restart + restore + re-offer from
                       ``t_next`` replays exactly
``serve.sigterm``      ``raise_signal(SIGTERM)`` before a window dispatches —
                       recoverable via the ``PreemptionCheckpointer``
                       save-now-and-exit path
``ingest.duplicate``   deliver a slot record twice (keyed by slot) —
                       recoverable: the sequencer dedupes exactly
``ingest.reorder``     delay a slot record a few arrivals (keyed by slot) —
                       recoverable: the sequencer reorders inside its bounded
                       window
``ingest.gap``         drop a slot record entirely — NOT value-recoverable:
                       the sequencer gap-fills by declared policy and counts
                       the slot
``ingest.nan``         rewrite a record's bandwidth to NaN — QUARANTINED
``ingest.negative``    rewrite a record's bandwidth negative — QUARANTINED
``ingest.absurd``      rewrite a record's bandwidth absurdly large —
                       QUARANTINED
=====================  ========================================================

Recoverable sites leave the served log stream bit-comparable (<= 1e-5) to
a fault-free run; gap/value sites perturb the affected slots by design and
are instead ACCOUNTED exactly (``serve.ingest`` quarantine + gap-fill
counters).  The port's soak differential lives in
``tests/test_torch_stream.py``.

**Determinism scheme.**  Every decision folds ``(seed, site, step)`` into a
``numpy`` generator through a stable crc32 digest (``fold_rng`` — same
construction as ``data.scenarios._rng``; never ``hash``, which is salted).
A site *fires at most once per (site, step) pair per engine* (``_fired``):
after a crash-and-restore the serving loop re-serves the same windows, and a
scheduled fault that re-fired on every replay would loop the run forever.
The consumed-once set lives on the engine, which the caller creates ONCE
per chaos run and shares across restarts — so "replayable" means the whole
run's fault event sequence, crashes and recoveries included, is identical
for identical ``(seed, schedule)``.

**Threads.**  The checkpoint writer thread fires the ``ckpt.*`` sites while
the serving thread fires the others, so ``fire`` decides and appends under
one lock: the consumed-once set and ``events`` stay consistent.  The order
in which two threads' firings land in ``events`` is the scheduler's; a
replay is identical as the set of firings, and ordered by ``(step,
site)``.
"""
from __future__ import annotations

import json
import signal
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Set, Tuple, Union

import numpy as np


class ChaosError(RuntimeError):
    """The injected mid-window exception (``serve.exception``)."""


# site name -> short description; the registry a schedule is validated
# against (grouped into families by prefix: ckpt / source / serve / ingest)
SITES: Dict[str, str] = {
    "ckpt.bitflip": "flip one byte of a committed data.bin",
    "ckpt.truncate": "truncate a committed data.bin",
    "ckpt.torn_manifest": "truncate a committed manifest.json mid-document",
    "ckpt.save_latency": "sleep inside the checkpoint writer",
    "source.stall": "a source poll returns nothing",
    "source.timeout": "a source poll times out",
    "serve.exception": "raise ChaosError before a window dispatch",
    "serve.sigterm": "raise SIGTERM before a window dispatch",
    "ingest.duplicate": "deliver a slot record twice",
    "ingest.reorder": "delay a slot record a few arrivals",
    "ingest.gap": "drop a slot record entirely",
    "ingest.nan": "rewrite a record's bandwidth to NaN",
    "ingest.negative": "rewrite a record's bandwidth negative",
    "ingest.absurd": "rewrite a record's bandwidth absurdly large",
}

# sites whose effect is exactly recoverable (logs match a fault-free run)
RECOVERABLE_SITES = frozenset(
    s for s in SITES
    if not s.startswith("ingest.")
    or s in ("ingest.duplicate", "ingest.reorder"))


def fold_rng(seed: int, *parts: Union[int, str]) -> np.random.Generator:
    """A generator pure in ``(seed, *parts)``: strings enter through a
    stable crc32 digest, ints directly — the host-side mirror of the codec
    key's ``fold_in`` scheme (``fleet.slot_camera_keys``)."""
    folded: Tuple[int, ...] = tuple(
        zlib.crc32(p.encode()) if isinstance(p, str) else int(p)
        for p in parts)
    return np.random.default_rng((int(seed),) + folded)


@dataclass(frozen=True)
class SiteSpec:
    """When (and how hard) one site fires.

    ``at``: explicit step indices (window number for serve/ckpt sites, slot
    index for ingest sites, poll ordinal for source sites).  ``rate``: an
    additional per-step Bernoulli drawn from the fold.  ``mag``: the
    site-specific magnitude (seconds for ``ckpt.save_latency`` /
    ``source.stall`` backpressure, ignored elsewhere)."""
    at: Tuple[int, ...] = ()
    rate: float = 0.0
    mag: float = 0.0

    @staticmethod
    def of(spec: Union["SiteSpec", Dict[str, Any]]) -> "SiteSpec":
        if isinstance(spec, SiteSpec):
            return spec
        return SiteSpec(at=tuple(int(t) for t in spec.get("at", ())),
                        rate=float(spec.get("rate", 0.0)),
                        mag=float(spec.get("mag", 0.0)))


class ChaosEngine:
    """The seeded fault scheduler the instrumented components consult.

    ``schedule`` maps registered site names to ``SiteSpec``s (or plain
    dicts).  ``fire(site, step)`` is the single decision point: it returns
    True iff the site is scheduled at that step (explicit ``at`` index or a
    fold-drawn Bernoulli under ``rate``) AND the (site, step) pair has not
    fired before on this engine (consumed-once; see the module docstring).
    Every firing appends a structured event to ``events``."""

    def __init__(self, seed: int, schedule: Dict[str, Any]):
        unknown = sorted(set(schedule) - set(SITES))
        if unknown:
            raise ValueError(f"unknown chaos sites {unknown}; registered "
                             f"sites: {sorted(SITES)}")
        self.seed = int(seed)
        self.schedule: Dict[str, SiteSpec] = {
            name: SiteSpec.of(spec) for name, spec in schedule.items()}
        self.events: List[Dict[str, Any]] = []
        self._fired: Set[Tuple[str, int]] = set()
        self._lock = threading.Lock()

    # -- decisions -------------------------------------------------------------

    def rng(self, site: str, step: int) -> np.random.Generator:
        return fold_rng(self.seed, site, step)

    def scheduled(self, site: str, step: int) -> bool:
        """Pure in (seed, schedule, site, step) — no consumed-once state."""
        spec = self.schedule.get(site)
        if spec is None:
            return False
        if int(step) in spec.at:
            return True
        if spec.rate > 0.0:
            return bool(self.rng(site, step).uniform() < spec.rate)
        return False

    def fire(self, site: str, step: int, **info: Any) -> bool:
        """Consumed-once ``scheduled``: True at most once per (site, step)
        per engine, with the firing recorded in ``events``."""
        if site not in SITES:
            raise ValueError(f"unknown chaos site {site!r}")
        key = (site, int(step))
        with self._lock:
            if key in self._fired or not self.scheduled(site, step):
                return False
            self._fired.add(key)
            self.events.append({"site": site, "step": int(step), **info})
        return True

    def counts(self) -> Dict[str, int]:
        """Fired events per site (zero-filled over the schedule's sites)."""
        out = {site: 0 for site in self.schedule}
        with self._lock:
            events = list(self.events)
        for e in events:
            out[e["site"]] = out.get(e["site"], 0) + 1
        return out

    def mag(self, site: str) -> float:
        spec = self.schedule.get(site)
        return spec.mag if spec is not None else 0.0

    # -- component hooks -------------------------------------------------------
    #
    # ``ckpt.AsyncSaver`` and ``serve.stream.StreamingFleetRunner`` call
    # these (duck-typed — ckpt never imports this module); each consults
    # only its own site family.

    def on_save_start(self, step: int) -> None:
        """Checkpoint-writer entry: ``ckpt.save_latency`` sleeps ``mag``
        seconds here (inside the writer thread for async saves — the
        serving loop only feels it on a blocking preemption save)."""
        if self.fire("ckpt.save_latency", step,
                     sleep_s=self.mag("ckpt.save_latency")):
            time.sleep(max(0.0, self.mag("ckpt.save_latency")))

    def on_save_committed(self, path: Union[str, Path], step: int) -> None:
        """Post-commit: the checkpoint-corruption family.  Models storage
        rot / torn writes landing AFTER the commit protocol succeeded —
        exactly the failures checksums + generation fallback must catch."""
        path = Path(path)
        if self.fire("ckpt.bitflip", step, path=str(path)):
            corrupt_bitflip(path, self.rng("ckpt.bitflip", step))
        if self.fire("ckpt.truncate", step, path=str(path)):
            corrupt_truncate(path, self.rng("ckpt.truncate", step))
        if self.fire("ckpt.torn_manifest", step, path=str(path)):
            corrupt_torn_manifest(path, self.rng("ckpt.torn_manifest", step))

    def pre_window(self, window: int) -> None:
        """Right before a window dispatches (the runner's chaos hook):
        the crash family."""
        if self.fire("serve.exception", window):
            raise ChaosError(f"chaos: injected exception before window "
                             f"{window}")
        if self.fire("serve.sigterm", window):
            signal.raise_signal(signal.SIGTERM)


# -- checkpoint corruptors ----------------------------------------------------
#
# Operate on a COMMITTED checkpoint directory (the ckpt layout: data.*.bin
# + manifest.json + COMMITTED).  Each is deterministic given the passed
# generator.

def _data_files(path: Path) -> List[Path]:
    files = sorted(path.glob("data.*.bin"))
    if not files:
        raise FileNotFoundError(f"no data files under {path}")
    return files


def corrupt_bitflip(path: Path, rng: np.random.Generator) -> int:
    """Flip one bit of one byte of ``data.bin``; returns the offset."""
    fp = _data_files(Path(path))[0]
    data = bytearray(fp.read_bytes())
    off = int(rng.integers(0, max(1, len(data))))
    data[off] ^= 1 << int(rng.integers(0, 8))
    fp.write_bytes(bytes(data))
    return off

def corrupt_truncate(path: Path, rng: np.random.Generator) -> int:
    """Truncate ``data.bin`` to a random prefix; returns the new length."""
    fp = _data_files(Path(path))[0]
    data = fp.read_bytes()
    keep = int(rng.integers(0, max(1, len(data) - 1)))
    fp.write_bytes(data[:keep])
    return keep


def corrupt_torn_manifest(path: Path, rng: np.random.Generator) -> int:
    """Truncate ``manifest.json`` mid-document (a torn metadata write);
    returns the new length."""
    fp = Path(path) / "manifest.json"
    text = fp.read_text()
    keep = int(rng.integers(1, max(2, len(text) // 2)))
    fp.write_text(text[:keep])
    return keep


# -- schedule (de)serialization -----------------------------------------------

def schedule_to_json(schedule: Dict[str, SiteSpec]) -> str:
    return json.dumps({k: {"at": list(SiteSpec.of(v).at),
                           "rate": SiteSpec.of(v).rate,
                           "mag": SiteSpec.of(v).mag}
                       for k, v in schedule.items()}, indent=1, sort_keys=True)


def schedule_from_json(text: str) -> Dict[str, SiteSpec]:
    return {k: SiteSpec.of(v) for k, v in json.loads(text).items()}
