"""The port's hardened ingest (``repro_torch.serve.ingest``) against the JAX
package's: the same line-protocol records, malformed and NaN lines,
duplicates, out-of-order slots, gaps and ``ChaosSource`` rewrites go
through both packages' ``StreamIngestor`` into a stub runner, and both
offer the same slots and give the same counters and events.  The stub
stands in for ``StreamingFleetRunner`` through the calls the ingestor
makes (``offer``, ``serve``, ``note_ingest``, ``t_next``,
``queued_slots``); the runner itself is held to JAX's in
``test_torch_stream.py``."""
import socket
import threading
from dataclasses import dataclass

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.ft import chaos as j_chaos  # noqa: E402
from repro.serve import ingest as j_ing  # noqa: E402
from repro_torch.data.scenarios import (make_chaos_schedule,  # noqa: E402
                                        make_soak_stream)
from repro_torch.ft import chaos as t_chaos  # noqa: E402
from repro_torch.serve import ingest as t_ing  # noqa: E402

C = 3
PACKAGES = {"jax": (j_ing, j_chaos), "port": (t_ing, t_chaos)}


@dataclass
class _Cfg:
    queue_slots: int
    window_slots: int


class StubRunner:
    """The runner surface the ingestor talks to: a bounded queue served
    in windows, with the runner's accounting of ``note_ingest``."""

    def __init__(self, window=4, queue=8):
        self.cfg = _Cfg(queue, window)
        self._C = C
        self._t = 0
        self._queue = []
        self.served = []            # (kbps, live row) per served slot
        self.windows = 0
        self.quarantined = {}
        self.quarantined_slots = 0
        self.gap_filled_slots = 0
        self.duplicates = 0
        self.out_of_order = 0
        self.events = []

    @property
    def t_next(self):
        return self._t

    def queued_slots(self):
        return len(self._queue)

    def note_ingest(self, kind, **info):
        if kind == "quarantine":
            r = str(info.get("reason"))
            self.quarantined[r] = self.quarantined.get(r, 0) + 1
            self.quarantined_slots += 1
        elif kind == "gap_fill":
            self.gap_filled_slots += 1
        elif kind == "duplicate":
            self.duplicates += 1
        elif kind == "out_of_order":
            self.out_of_order += 1
        self.events.append({"kind": kind, **info})

    def offer(self, kbps, faults=None):
        assert np.all(np.isfinite(kbps)) and np.all(kbps >= 0)
        room = self.cfg.queue_slots - len(self._queue)
        take = min(room, len(kbps))
        self._queue += [(float(kbps[i]), tuple(bool(b) for b in faults[i]))
                        for i in range(take)]
        return take

    def serve(self, flush=False):
        n = 0
        while len(self._queue) >= self.cfg.window_slots or (
                flush and self._queue):
            k = min(self.cfg.window_slots, len(self._queue))
            self.served += self._queue[:k]
            self._queue = self._queue[k:]
            self._t += k
            self.windows += 1
            n += 1
        return n

    def record(self):
        return (self.served, self.windows, self.quarantined,
                self.quarantined_slots, self.gap_filled_slots,
                self.duplicates, self.out_of_order, _plain(self.events))


def _plain(events):
    """Events with floats that compare (NaN -> 'nan')."""
    out = []
    for e in events:
        out.append({k: ("nan" if isinstance(v, float) and np.isnan(v) else v)
                    for k, v in e.items()})
    return out


def _stream(T=40, seed=0):
    trace, live = make_soak_stream(T, num_cams=C, seed=seed)
    return [t_ing.format_record(t, trace[t], live[t]) for t in range(T)]


def _messy(lines):
    """Garbage, NaN, negative and absurd values, wrong arity, dead rows,
    duplicates, out-of-order slots and a gap, among clean records."""
    out = list(lines)
    out[3], out[4] = out[4], out[3]                  # out of order
    out.insert(6, out[5])                            # duplicate
    out[9] = "9 nan 111"                             # quarantined, filled
    out[12] = "not a record"
    out.insert(13, "13 -5.0 101")
    out.insert(14, "13 1e9 101")
    out[20] = "20 100.0 11"                          # arity
    out[21] = "21 100.0 000"                         # no live camera
    del out[25]                                      # a gap
    out.insert(30, out[33])                          # early arrival
    out.append("1 100.0 111")                        # late duplicate
    return out


def _pump(pkg, lines, *, chaos=None, window=4, queue=8, batch=5,
          cfg=None, until=None, flush=True):
    ing, ch = PACKAGES[pkg]
    runner = StubRunner(window, queue)
    src = ing.ListSource(lines, batch=batch)
    if chaos is not None:
        seed, sched = chaos
        src = ing.ChaosSource(src, ch.ChaosEngine(seed, sched))
    sleeps = []
    it = ing.StreamIngestor(runner, src, cfg or ing.IngestConfig(),
                            sleep_fn=sleeps.append)
    it.pump(until_t=until, flush=flush)
    return runner.record() + (sleeps, it.polls, it.records_in)


# -- the protocol -------------------------------------------------------------

LINES = ["", "1 2", "1 2 3 4", "x 100.0 111", "1 abc 111", "-1 100.0 111",
         "1 100.0 12a", "1 100.0 201", "3 nan 11", "4 inf 1", "5 -5.0 1",
         "6 1e9 1", "7 100.0 00", "8 100.0 1", "9 1380.5 101",
         "  10   64.0   110  "]


@pytest.mark.parametrize("line", LINES)
def test_parse_and_validate_match_jax(line):
    outs = []
    for ing, _ in PACKAGES.values():
        try:
            rec = ing.parse_record(line)
        except ValueError as e:
            outs.append(("error", str(e)))
            continue
        outs.append((rec.t, str(rec.kbps), rec.live,
                     ing.validate_record(rec, 3), ing.validate_record(rec, 1),
                     ing.format_record(rec.t, rec.kbps, rec.live)))
    assert outs[0] == outs[1]


def test_constants_match_jax():
    assert t_ing.DEFAULT_MAX_KBPS == j_ing.DEFAULT_MAX_KBPS
    assert t_ing.FILL_FLOOR_KBPS == j_ing.FILL_FLOOR_KBPS
    assert t_ing.IngestConfig().__dict__ == j_ing.IngestConfig().__dict__


def test_sequencer_matches_jax():
    """Pushes with duplicates, reorders and holes, then a flush to a
    later slot: the same slots out, the same counters and events."""
    ts = [0, 1, 3, 2, 2, 7, 5, 6, 4, 12, 9, 1, 14]
    outs = []
    for ing, _ in PACKAGES.values():
        ev = []
        seq = ing.SlotSequencer(C, start_t=0, reorder_window=3,
                                on_event=lambda k, **i: ev.append((k, i)))
        got = []
        for t in ts:
            got += seq.push(ing.SlotRecord(t, 100.0 + t, (True, t % 2 == 0,
                                                          True)))
        got += seq.flush(until_t=17)
        outs.append(([(t, k, tuple(lv)) for t, k, lv in got], ev,
                     seq.duplicates, seq.out_of_order, seq.gap_filled,
                     seq.gap_slots))
    assert outs[0] == outs[1]
    assert outs[1][2] and outs[1][3] and outs[1][4]


def test_backoff_matches_jax():
    a, b = j_ing.Backoff(0.001, 2.0, 0.05), t_ing.Backoff(0.001, 2.0, 0.05)
    assert [a.next() for _ in range(10)] == [b.next() for _ in range(10)]
    a.reset(), b.reset()
    assert a.next() == b.next() == 0.001


# -- the pipeline ---------------------------------------------------------------

def test_clean_stream_matches_jax():
    lines = _stream()
    want, got = _pump("jax", lines), _pump("port", lines)
    assert got == want
    assert len(got[0]) == 40 and got[3] == got[4] == 0


def test_messy_stream_matches_jax():
    lines = _messy(_stream())
    want, got = _pump("jax", lines), _pump("port", lines)
    assert got == want
    served, _, quarantined, q_slots, gaps, dups, ooo = got[:7]
    assert len(served) == 40
    assert quarantined == {"non_finite": 1, "parse": 1, "negative": 1,
                           "absurd": 1, "liveness_arity": 1,
                           "liveness_dead": 1}
    assert q_slots == 6 and gaps >= 5 and dups >= 2 and ooo >= 2


@pytest.mark.parametrize("poisoned", [False, True])
def test_chaos_source_stream_matches_jax(poisoned):
    """Every ingest and source site of the chaos schedule (duplicates,
    delays, stalls, timeouts, and with ``poisoned`` gaps and NaN,
    negative and absurd rewrites) on both packages' engines."""
    T = 48
    sched = {k: v for k, v in make_chaos_schedule(
        T, 8, poisoned=poisoned).items()
        if k.startswith(("ingest.", "source."))}
    lines = _stream(T)
    # the soak loop's reorder window: three polls of 8 records
    cfg_j = j_ing.IngestConfig(reorder_window=24)
    cfg_t = t_ing.IngestConfig(reorder_window=24)
    want = _pump("jax", lines, chaos=(11, sched), cfg=cfg_j, batch=8)
    got = _pump("port", lines, chaos=(11, sched), cfg=cfg_t, batch=8)
    assert got == want
    assert len(got[0]) == T
    if poisoned:
        assert got[3] > 0 and got[4] >= got[3]
    else:
        assert got[3] == got[4] == 0 and got[5] > 0


def test_backpressure_and_partial_pump_match_jax():
    """A queue smaller than a burst holds the rest back (no shedding), and
    a pump that stops at ``until_t`` leaves the same state."""
    lines = _stream(24)
    for until, flush in ((10, False), (None, True)):
        want = _pump("jax", lines, window=4, queue=4, batch=12,
                     until=until, flush=flush)
        got = _pump("port", lines, window=4, queue=4, batch=12,
                    until=until, flush=flush)
        assert got == want


def test_stalled_source_raises_like_jax():
    outs = []
    for ing, _ in PACKAGES.values():
        class Dead:
            def read_lines(self):
                return []

            def exhausted(self):
                return False
        sleeps = []
        it = ing.StreamIngestor(StubRunner(), Dead(),
                                ing.IngestConfig(max_idle_polls=5),
                                sleep_fn=sleeps.append)
        with pytest.raises(ing.SourceStalled, match="5 polls"):
            it.pump(until_t=8)
        outs.append(sleeps)
    assert outs[0] == outs[1] and len(outs[1]) == 4


def test_file_tail_source_incremental(tmp_path):
    p = tmp_path / "stream.txt"
    src = t_ing.FileTailSource(p)
    assert src.read_lines() == [] and not src.exhausted()
    p.write_text("0 100.0 111\n1 20")
    assert src.read_lines() == ["0 100.0 111"]
    with open(p, "a") as f:
        f.write("0.0 101\n")
    assert src.read_lines() == ["1 200.0 101"]


def test_socket_source_reassembles_lines():
    """Records split across packets, over a localhost socket."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def feed():
        conn, _ = srv.accept()
        for chunk in (b"0 100.0 1", b"11\n1 200.0 101\n2 3", b"00.0 011\n"):
            conn.sendall(chunk)
        conn.close()
    th = threading.Thread(target=feed)
    th.start()
    src = t_ing.SocketLineSource("127.0.0.1", port, recv_timeout=0.5)
    got = []
    while not src.exhausted():
        try:
            got += src.read_lines()
        except t_ing.SourceTimeout:
            pass
    th.join()
    src.close()
    srv.close()
    assert got == ["0 100.0 111", "1 200.0 101", "2 300.0 011"]
