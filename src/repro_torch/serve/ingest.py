"""Hardened real-source ingest for the windowed serving loop.

The counterpart of ``repro.serve.ingest`` (numpy and the standard library
only, copied so that the port imports nothing of the JAX package).  It
talks to the runner only through ``offer``, ``serve``, ``note_ingest``,
``t_next``, ``queued_slots``, ``cfg.queue_slots``, ``quarantined_slots``
and ``_C``.

``StreamingFleetRunner`` ingests well-formed in-process arrays via
``offer()``; a real fleet's slots arrive over flaky transports (Raspberry
Pis behind fluctuating links — the paper's deployment) as a byte stream
that stalls, duplicates, reorders, gaps and occasionally carries garbage.
This module is the stage between a raw source and the runner's bounded
queue, and its contract is absolute: **no malformed input ever reaches the
device carry** — every slot the runner serves was either validated or
synthesized by a declared fill policy.

Pipeline (``StreamIngestor``)::

    source.read_lines()  ->  parse_record  ->  validate (quarantine lane)
        -> SlotSequencer (dedupe / bounded reorder / gap-fill)
        -> runner.offer(contiguous slots)  ->  runner.serve()

**Line protocol.**  One record per line: ``"<t> <kbps> <live-bits>"``
(global slot index, bandwidth in Kbps, one ``0``/``1`` per camera, e.g.
``"17 1380.5 101"``).  ``format_record`` / ``parse_record`` are exact
inverses; anything unparseable quarantines with reason ``"parse"``.

**Sources.**  ``FileTailSource`` tails a growing file (partial trailing
lines buffer until their newline arrives); ``SocketLineSource`` speaks the
same protocol over TCP (connect retries with exponential backoff, short
recv timeouts, split packets reassembled); ``ListSource`` replays an
in-memory script (tests, benches).  All expose ``read_lines()`` —
non-blocking-ish, returning whatever complete lines are available now.
The ingest loop wraps every poll in retry/timeout/exponential-backoff
(``Backoff``): an empty or failed poll sleeps ``poll_backoff_s`` doubling
up to ``max_backoff_s`` and resets on the next successful read;
``max_idle_polls`` consecutive empty polls raise ``SourceStalled`` (the
stream is declared dead, not silently hung).

**Fault model** (what quarantines, what is repaired, what is filled):

  * *Duplicates* — a record for a slot already emitted (or already pending)
    is dropped and counted (``duplicates``).  Exactly recoverable.
  * *Out-of-order* — records up to ``reorder_window`` slots ahead of the
    next expected slot are held and re-sequenced (``out_of_order`` counts
    the early arrivals).  Exactly recoverable within the window.
  * *Gaps* — when the sequencer is forced ``reorder_window`` slots past a
    missing slot (or the stream flushes), the hole is GAP-FILLED by the
    declared policy: bandwidth = hold-last-emitted (``FILL_FLOOR_KBPS`` —
    the codec ladder's minimum rung — before the first real record, so a
    start-of-stream gap still feeds the allocator a schedulable slot
    instead of a zero-bandwidth row), and a
    maximally-dead liveness row.  NOTE: the fleet's control step requires
    >= 1 live camera per slot (``fleet_episode`` rejects all-dead rows), so
    "maximally dead" keeps only the anchor camera 0 alive — the closest
    realizable form of the all-dead row the fault model calls for.  Filled
    slots are counted and indexed (``gap_filled``, ``gap_slots``): they are
    NOT value-recoverable and the accounting is the contract.
  * *Garbage values* — the QUARANTINE lane: non-finite bandwidth (NaN/inf),
    negative bandwidth, absurd bandwidth (> ``max_kbps``), liveness rows of
    the wrong arity or with zero live cameras, and unparseable lines are
    rejected BEFORE sequencing, counted per reason (``quarantined``).  The
    slot then reads as missing and gap-fills clean — poisoned input can
    never NaN the compiled episode.

Chaos injection (``ChaosSource``) wraps any source and perturbs the record
stream at the registered ``ingest.*`` / ``source.*`` sites of a seeded
``ft.chaos.ChaosEngine`` — duplicates, bounded delays, drops, value
rewrites, stalls and timeouts, all replayable from ``(seed, schedule)``.
"""
from __future__ import annotations

import socket
import time
from dataclasses import dataclass
from pathlib import Path
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple, Union)
from collections import deque

import numpy as np

# bandwidth above this is declared absurd and quarantined: two decades above
# the scenario catalog's largest opening (spike family peaks at 6 Mbps)
DEFAULT_MAX_KBPS = 1e6

# gap-fill bandwidth before the FIRST real record: hold-last has nothing to
# hold at stream start, so fills floor at the codec bitrate ladder's minimum
# rung (CodecConfig.bitrates_kbps[0]) — never an uninitialized/zero row
FILL_FLOOR_KBPS = 50.0


class SourceStalled(RuntimeError):
    """The source produced nothing for ``max_idle_polls`` consecutive
    polls — the stream is declared dead instead of silently hanging."""


class SourceTimeout(RuntimeError):
    """One poll timed out (retried with backoff by the ingest loop)."""


@dataclass(frozen=True)
class SlotRecord:
    """One parsed line-protocol record: global slot index, bandwidth,
    per-camera liveness."""
    t: int
    kbps: float
    live: Tuple[bool, ...]


def format_record(t: int, kbps: float, live: Sequence[bool]) -> str:
    """``SlotRecord`` -> line (exact inverse of ``parse_record``)."""
    bits = "".join("1" if bool(b) else "0" for b in live)
    return f"{int(t)} {float(kbps)!r} {bits}"


def parse_record(line: str) -> SlotRecord:
    """Line -> ``SlotRecord``; raises ``ValueError`` on anything that is
    not ``"<int> <float> <01-bits>"`` (the quarantine lane catches it)."""
    parts = line.strip().split()
    if len(parts) != 3:
        raise ValueError(f"expected 3 fields, got {len(parts)}: {line!r}")
    t = int(parts[0])
    kbps = float(parts[1])   # accepts 'nan'/'inf' — the VALIDATOR rejects
    if t < 0:
        raise ValueError(f"negative slot index: {line!r}")
    bits = parts[2]
    if bits.strip("01"):
        raise ValueError(f"liveness field must be 0/1 bits: {line!r}")
    return SlotRecord(t=t, kbps=kbps, live=tuple(b == "1" for b in bits))


def validate_record(rec: SlotRecord, num_cams: int,
                    max_kbps: float = DEFAULT_MAX_KBPS) -> Optional[str]:
    """The quarantine gate: returns the rejection reason, or None for a
    clean record.  Everything here is checked BEFORE a value can touch the
    sequencer, the bounded queue or the device carry."""
    if not np.isfinite(rec.kbps):
        return "non_finite"
    if rec.kbps < 0.0:
        return "negative"
    if rec.kbps > max_kbps:
        return "absurd"
    if len(rec.live) != num_cams:
        return "liveness_arity"
    if not any(rec.live):
        # the fleet control step requires >= 1 live camera per slot
        return "liveness_dead"
    return None


# -- sources -------------------------------------------------------------------


class ListSource:
    """Replay an in-memory list of lines, ``batch`` per poll (tests and
    benches; also the shape a restarted feeder uses to re-offer from
    ``t_next``)."""

    def __init__(self, lines: Sequence[str], batch: int = 8):
        self._lines = list(lines)
        self._pos = 0
        self.batch = batch

    def read_lines(self) -> List[str]:
        out = self._lines[self._pos:self._pos + self.batch]
        self._pos += len(out)
        return out

    def exhausted(self) -> bool:
        return self._pos >= len(self._lines)


class FileTailSource:
    """Tail a growing file of line-protocol records (``tail -f`` shape).

    Reads from the current offset each poll; a partial trailing line (the
    writer got ahead of its newline) buffers until completed — records are
    never split.  A missing file reads as empty (the writer may not have
    created it yet; the ingest loop's backoff handles the wait)."""

    def __init__(self, path: Union[str, Path], start: int = 0):
        self.path = Path(path)
        self._offset = int(start)
        self._partial = ""

    def read_lines(self) -> List[str]:
        if not self.path.exists():
            return []
        with open(self.path, "r") as f:
            f.seek(self._offset)
            chunk = f.read()
            self._offset = f.tell()
        if not chunk:
            return []
        text = self._partial + chunk
        lines = text.split("\n")
        self._partial = lines.pop()   # "" when chunk ended on a newline
        return [ln for ln in lines if ln.strip()]

    def exhausted(self) -> bool:
        return False   # a tail never knows the writer is done


class SocketLineSource:
    """Line-protocol records over TCP.

    Connects lazily with exponential-backoff retries (``connect_retries``
    polls of ``Backoff`` delays — an ingest process that starts before its
    feeder must wait, not die); each poll does one short-timeout ``recv``
    and reassembles complete lines across packet boundaries.  A dead socket
    (``recv`` raising ``OSError``) is closed immediately and the next poll
    reconnects from scratch — exactly one fd is ever live, and a successful
    reconnect resets the backoff ladder to its initial delay.  A closed
    peer marks the source exhausted."""

    def __init__(self, host: str, port: int, *, recv_timeout: float = 0.05,
                 connect_retries: int = 20, backoff: Optional["Backoff"] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.host, self.port = host, int(port)
        self.recv_timeout = float(recv_timeout)
        self.connect_retries = int(connect_retries)
        self._backoff = backoff or Backoff()
        self._sleep = sleep_fn
        self._sock: Optional[socket.socket] = None
        self._partial = ""
        self._closed = False

    def _connect(self) -> None:
        last: Optional[Exception] = None
        for _ in range(self.connect_retries):
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=1.0)
                self._sock.settimeout(self.recv_timeout)
                self._backoff.reset()
                return
            except OSError as e:
                last = e
                self._sleep(self._backoff.next())
        raise SourceStalled(
            f"could not connect to {self.host}:{self.port} after "
            f"{self.connect_retries} attempts: {last}")

    def read_lines(self) -> List[str]:
        if self._closed:
            return []
        if self._sock is None:
            self._connect()
        try:
            chunk = self._sock.recv(65536)
        except socket.timeout:
            raise SourceTimeout(f"recv timed out after {self.recv_timeout}s")
        except OSError as e:
            # the socket is dead: close it NOW (no fd leak) and null it so
            # the next poll reconnects via _connect(), whose success path
            # resets the backoff ladder to its initial delay
            self._sock.close()
            self._sock = None
            raise SourceTimeout(f"recv failed: {e}")
        if chunk == b"":
            self._closed = True     # peer closed: stream complete
            return []
        text = self._partial + chunk.decode("utf-8", errors="replace")
        lines = text.split("\n")
        self._partial = lines.pop()
        return [ln for ln in lines if ln.strip()]

    def exhausted(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class ChaosSource:
    """Wrap any source with a seeded ``ft.chaos.ChaosEngine``'s ingest and
    source fault sites (see ``ft.chaos`` for the registry).  Delivery
    faults key off the RECORD's slot index — a restarted feeder that
    re-reads the same slots replays the identical perturbation (and the
    engine's consumed-once set keeps already-fired faults from looping a
    recovery).  Source faults key off the poll ordinal."""

    def __init__(self, inner: Any, engine: Any):
        self.inner = inner
        self.engine = engine
        self._poll = 0
        self._delayed: List[List] = []   # [polls_left, line]

    def _perturb(self, line: str) -> List[str]:
        try:
            rec = parse_record(line)
        except ValueError:
            return [line]            # unparseable passes through untouched
        t, eng = rec.t, self.engine
        if eng.fire("ingest.gap", t):
            return []
        out = [line]
        if eng.fire("ingest.nan", t):
            out = [format_record(t, float("nan"), rec.live)]
        elif eng.fire("ingest.negative", t):
            out = [format_record(
                t, -float(eng.rng("ingest.negative", t).uniform(1, 500)),
                rec.live)]
        elif eng.fire("ingest.absurd", t):
            out = [format_record(
                t, float(eng.rng("ingest.absurd", t).uniform(1e8, 1e9)),
                rec.live)]
        if eng.fire("ingest.duplicate", t):
            out = out + out
        if out and eng.fire("ingest.reorder", t):
            delay = int(eng.rng("ingest.reorder", t).integers(1, 3))
            self._delayed.append([delay, out[0]])
            out = out[1:]
        return out

    def read_lines(self) -> List[str]:
        self._poll += 1
        if self.engine.fire("source.timeout", self._poll):
            raise SourceTimeout("chaos: injected source timeout")
        stalled = self.engine.fire("source.stall", self._poll)
        lines = [] if stalled else self.inner.read_lines()
        out: List[str] = []
        # release held (reordered) lines whose delay expired
        for item in self._delayed:
            item[0] -= 1
        ready = [it for it in self._delayed if it[0] <= 0
                 or (self.inner.exhausted() and not lines)]
        self._delayed = [it for it in self._delayed if it not in ready]
        for ln in lines:
            out.extend(self._perturb(ln))
        out.extend(it[1] for it in ready)
        return out

    def exhausted(self) -> bool:
        return self.inner.exhausted() and not self._delayed


# -- backoff -------------------------------------------------------------------


class Backoff:
    """Deterministic exponential backoff: ``initial * factor**k`` capped at
    ``ceiling``; ``reset()`` on success."""

    def __init__(self, initial: float = 0.001, factor: float = 2.0,
                 ceiling: float = 0.25):
        self.initial, self.factor, self.ceiling = initial, factor, ceiling
        self._k = 0

    def next(self) -> float:
        d = min(self.ceiling, self.initial * (self.factor ** self._k))
        self._k += 1
        return d

    def reset(self) -> None:
        self._k = 0


# -- sequencer -----------------------------------------------------------------


@dataclass
class IngestConfig:
    """Knobs for the ingest stage.  ``reorder_window``: how far ahead of
    the next expected slot an arrival may run before the hole it implies is
    declared a gap; ``max_kbps``: the absurd-value quarantine ceiling;
    ``poll_backoff_s``/``backoff_factor``/``max_backoff_s``: the
    exponential read-retry ladder; ``max_idle_polls``: consecutive empty
    polls before the stream is declared dead (``SourceStalled``)."""
    reorder_window: int = 4
    max_kbps: float = DEFAULT_MAX_KBPS
    poll_backoff_s: float = 0.001
    backoff_factor: float = 2.0
    max_backoff_s: float = 0.25
    max_idle_polls: int = 500


class SlotSequencer:
    """Slot-sequence tracking over validated records: dedupes duplicates,
    reorders bounded out-of-order arrivals, gap-fills holes by the declared
    policy (hold-last bandwidth — ``FILL_FLOOR_KBPS`` before the first real
    record — + anchor-only liveness; see the module docstring).  Emits
    ``(t, kbps, live_row)`` strictly in slot order.

    ``on_event(kind, **info)`` fires for every non-clean decision
    (``duplicate`` / ``out_of_order`` / ``gap_fill``) so the runner's event
    log and counters stay the single serving record."""

    def __init__(self, num_cams: int, start_t: int = 0,
                 reorder_window: int = 4,
                 on_event: Optional[Callable[..., None]] = None):
        if reorder_window < 1:
            raise ValueError(f"reorder_window must be >= 1: {reorder_window}")
        self.num_cams = int(num_cams)
        self.next_t = int(start_t)
        self.reorder_window = int(reorder_window)
        self.pending: Dict[int, SlotRecord] = {}
        self.on_event = on_event or (lambda *a, **k: None)
        self.duplicates = 0
        self.out_of_order = 0
        self.gap_filled = 0
        self.gap_slots: List[int] = []
        # hold-last fill value; floored before the first real record so a
        # start-of-stream gap emits a schedulable (non-zero) bandwidth row
        self._last_kbps = FILL_FLOOR_KBPS

    def _fill_row(self) -> Tuple[float, np.ndarray]:
        live = np.zeros(self.num_cams, bool)
        live[0] = True                   # the fleet needs >= 1 live camera
        return self._last_kbps, live

    def _emit(self, rec: SlotRecord) -> Tuple[int, float, np.ndarray]:
        self._last_kbps = float(rec.kbps)
        return rec.t, float(rec.kbps), np.asarray(rec.live, bool)

    def _fill(self, t: int) -> Tuple[int, float, np.ndarray]:
        kbps, live = self._fill_row()
        self.gap_filled += 1
        self.gap_slots.append(int(t))
        self.on_event("gap_fill", slot=int(t), kbps=kbps)
        return int(t), kbps, live

    def _drain(self, force: bool = False) -> List[Tuple[int, float, np.ndarray]]:
        out = []
        while self.pending:
            if self.next_t in self.pending:
                out.append(self._emit(self.pending.pop(self.next_t)))
            elif force or (max(self.pending) - self.next_t
                           >= self.reorder_window):
                out.append(self._fill(self.next_t))
            else:
                break
            self.next_t += 1
        return out

    def push(self, rec: SlotRecord) -> List[Tuple[int, float, np.ndarray]]:
        """One validated record in; zero or more in-order slots out."""
        if rec.t < self.next_t or rec.t in self.pending:
            self.duplicates += 1
            self.on_event("duplicate", slot=int(rec.t))
            return []
        if rec.t > self.next_t:
            self.out_of_order += 1
            self.on_event("out_of_order", slot=int(rec.t),
                          expected=int(self.next_t))
        self.pending[rec.t] = rec
        return self._drain()

    def flush(self, until_t: Optional[int] = None
              ) -> List[Tuple[int, float, np.ndarray]]:
        """End-of-stream: emit everything pending, gap-filling every hole
        (and, with ``until_t``, every missing slot up to it)."""
        out = self._drain(force=True)
        while until_t is not None and self.next_t < until_t:
            out.append(self._fill(self.next_t))
            self.next_t += 1
        return out


# -- the ingest pipeline -------------------------------------------------------


class StreamIngestor:
    """Pump a raw source into a ``StreamingFleetRunner``: parse ->
    quarantine -> sequence -> ``offer`` -> ``serve``, with read
    retry/backoff.  Quarantine and sequencing counters mirror onto the
    runner (``runner.note_ingest``) so they ride its event log, stats and
    checkpoints.

    Backpressure, not shedding: slots the bounded queue has no room for
    stay in ``self.out`` and re-offer next pump — the queue's explicit
    load-shed accounting (``dropped_slots``) remains the contract of the
    DIRECT ``offer()`` path, where the feeder owns retry."""

    def __init__(self, runner: Any, source: Any,
                 cfg: Optional[IngestConfig] = None, *,
                 start_t: Optional[int] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.runner = runner
        self.source = source
        self.cfg = cfg or IngestConfig()
        self.sleep = sleep_fn
        self.backoff = Backoff(self.cfg.poll_backoff_s,
                               self.cfg.backoff_factor,
                               self.cfg.max_backoff_s)
        start = runner.t_next if start_t is None else int(start_t)
        self.seq = SlotSequencer(
            runner._C, start_t=start,
            reorder_window=self.cfg.reorder_window,
            on_event=runner.note_ingest)
        self.out: Deque[Tuple[int, float, np.ndarray]] = deque()
        self.idle_polls = 0
        self.polls = 0
        self.records_in = 0

    # -- one poll --------------------------------------------------------------

    def poll(self) -> int:
        """One source read (retrying timeouts with backoff): parse,
        quarantine, sequence.  Returns how many records were ingested;
        raises ``SourceStalled`` after ``max_idle_polls`` empty polls."""
        self.polls += 1
        try:
            lines = self.source.read_lines()
        except SourceTimeout as e:
            self.runner.note_ingest("source_timeout", error=str(e))
            lines = []
        if not lines:
            self.idle_polls += 1
            if self.idle_polls >= self.cfg.max_idle_polls:
                raise SourceStalled(
                    f"source produced nothing for {self.idle_polls} polls "
                    f"(next expected slot {self.seq.next_t}; "
                    f"{self.records_in} records read so far, "
                    f"{self.runner.quarantined_slots} quarantined)")
            self.sleep(self.backoff.next())
            return 0
        self.idle_polls = 0
        self.backoff.reset()
        n = 0
        for line in lines:
            n += 1
            try:
                rec = parse_record(line)
            except ValueError as e:
                self.runner.note_ingest("quarantine", reason="parse",
                                        line=line[:80], error=str(e))
                continue
            reason = validate_record(rec, self.seq.num_cams,
                                     self.cfg.max_kbps)
            if reason is not None:
                self.runner.note_ingest("quarantine", reason=reason,
                                        slot=int(rec.t), kbps=float(rec.kbps))
                continue
            self.out.extend(self.seq.push(rec))
        self.records_in += n
        return n

    # -- offer + serve ---------------------------------------------------------

    def _offer_ready(self) -> int:
        """Offer as many in-order slots as the bounded queue has room for
        (backpressure keeps the rest in ``self.out``)."""
        room = max(0, self.runner.cfg.queue_slots
                   - self.runner.queued_slots())
        take = min(room, len(self.out))
        if take == 0:
            return 0
        batch = [self.out.popleft() for _ in range(take)]
        kbps = np.asarray([b[1] for b in batch], np.float64)
        live = np.stack([b[2] for b in batch])
        accepted = self.runner.offer(kbps, faults=live)
        # room was checked first, so the bounded queue accepted everything
        assert accepted == take, (accepted, take)
        return take

    def pump(self, until_t: Optional[int] = None, flush: bool = False) -> int:
        """Poll/offer/serve until the runner has served ``until_t`` slots
        (or, with ``until_t=None``, until the source is exhausted and every
        emitted slot is served).  ``flush=True`` additionally flushes the
        sequencer through ``until_t`` (gap-filling stream-tail holes) and
        serves a final partial window.  Returns windows served.  May raise
        whatever the runner's crash faults raise (``ChaosError``,
        ``SystemExit``) — the caller owns restart/restore — plus
        ``SourceStalled`` when the source dies."""
        served = 0
        while True:
            if until_t is not None and self.runner.t_next >= until_t:
                break
            if (self.source.exhausted() and not self.out
                    and not self.seq.pending):
                break
            if not self.source.exhausted():
                self.poll()
            elif self.seq.pending:
                # stream ended with holes/held slots outstanding: force the
                # sequencer through them (gap-fill by policy)
                self.out.extend(self.seq.flush(until_t))
            self._offer_ready()
            served += self.runner.serve()
        if flush:
            if until_t is not None:
                self.out.extend(self.seq.flush(until_t))
            while self.out:
                self._offer_ready()
                served += self.runner.serve()
            served += self.runner.serve(flush=True)
        return served
