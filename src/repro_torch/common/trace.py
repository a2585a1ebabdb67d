"""Spans and counters of the port, on the profiler's clock.

``span(name, **ids)`` is a context manager around a piece of host work;
``count(name, n=1)`` bumps a counter.  The recorder is *active* while a
``torch.profiler`` session records (the profiler's own enabled flag, one
global read) or after ``enable()``.  While it is inactive ``span``
returns one shared null context (no clock read, no span object) and
``count`` is an integer add.  While it is active a span records its name,
``time.perf_counter()`` start and end, its thread, its parent (the
innermost span open on the same thread) and its window: the fleet
stream's root span (``stream.window``) sets the window id, its children
inherit it, and a span opened on another thread is handed the id
explicitly (the checkpoint writer's ``ckpt.write``, ``window=step``).
While a profiler records, a span also opens ``torch.profiler.
record_function(name)``, so it lands in the profiler's Chrome trace as a
``user_annotation`` on the same clock as the card's records.

``timer(name, **ids)`` is a span that reads the clock whether or not the
recorder is active: the places that kept a list of seconds before there
were spans (``StreamingFleetRunner.window_walls`` and ``restore_s``,
``AsyncSaver.snapshot_s`` and ``write_s``) fill it from the same two
clock reads as the span.

``record(name, t0, t1, clock=, **ids)`` adds a finished span measured
elsewhere: the slot stages' device intervals (``stage.*``, the card's
``%globaltimer`` in seconds, ``clock="device"``), whose durations alone
mean anything next to the host's.

Spans stay in memory until ``clear()``, the newest ``MAX_SPANS`` of them
(an older span is dropped as a new one finishes, so a stream traced for
hours holds a bounded store); ``spans()`` returns them in the order they
finished.  No span belongs in code that a CUDA graph captures: it would
run once, at the capture.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional

import torch.autograd.profiler as _prof

# the spans kept: about 110 a window of the fleet stream at 16 cameras
# (host spans and 5 device spans a slot), so some 600 windows
MAX_SPANS = 1 << 16


class Span:
    """One finished span.  ``clock`` is ``"host"`` (``time.perf_counter``)
    or ``"device"`` (the card's timer: compare durations only); ``ids``
    holds the keyword ids a span was opened with besides ``window``."""
    __slots__ = ("id", "name", "t0", "t1", "thread", "parent", "window",
                 "clock", "ids")

    def __init__(self, id: int, name: str, t0: float, t1: float,
                 thread: int, parent: Optional[int], window: Optional[int],
                 clock: str, ids: Dict[str, Any]):
        self.id, self.name, self.t0, self.t1 = id, name, t0, t1
        self.thread, self.parent, self.window = thread, parent, window
        self.clock, self.ids = clock, ids

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {1e3 * self.seconds:.3f} ms, "
                f"window={self.window}, parent={self.parent}, "
                f"clock={self.clock!r}, ids={self.ids})")


class _Null:
    """The inactive recorder's span: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Recorder:
    """The process's spans and counters (see the module docstring)."""

    def __init__(self):
        self.enabled = False
        self.spans: Deque[Span] = collections.deque(maxlen=MAX_SPANS)
        self.counts: Dict[str, int] = {}
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> List["_Open"]:
        """The spans open on this thread, innermost last (a timer opened
        while the recorder was inactive included: nothing under it is
        recorded, so no span loses its parent)."""
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()


class _Open:
    """An open span.  A timer (``live`` False while the recorder is
    inactive as it opens) reads the clock all the same, and its
    ``seconds`` are read after exit."""
    __slots__ = ("name", "ids", "live", "id", "parent", "window", "t0",
                 "t1", "_rf")

    def __init__(self, name: str, ids: Dict[str, Any], live: bool):
        self.name, self.ids, self.live = name, ids, live
        self._rf = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "_Open":
        st = _REC.stack()
        if self.live:
            parent = st[-1] if st else None
            self.id = next(_REC.ids)
            self.parent = parent.id if parent else None
            self.window = self.ids.pop("window",
                                       parent.window if parent else None)
            if _prof._is_profiler_enabled:
                self._rf = _prof.record_function(self.name)
                self._rf.__enter__()
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        st = _REC.stack()
        if st and st[-1] is self:
            st.pop()
        if self.live:
            if self._rf is not None:
                self._rf.__exit__(*exc)
            _REC.spans.append(Span(
                self.id, self.name, self.t0, self.t1, threading.get_ident(),
                self.parent, self.window, "host", self.ids))
        return False


def _recording() -> bool:
    """Active, and no timer opened while inactive is open on this
    thread."""
    if not (_REC.enabled or _prof._is_profiler_enabled):
        return False
    st = _REC.stack()
    return not st or st[-1].live


def active() -> bool:
    """Whether spans are being recorded now."""
    return _REC.enabled or _prof._is_profiler_enabled


def enable(on: bool = True) -> None:
    """Record spans outside a profiler session too (``on=False``: only
    inside one)."""
    _REC.enabled = bool(on)


def span(name: str, **ids):
    """A span around the ``with`` block (see the module docstring)."""
    return _Open(name, ids, True) if _recording() else _NULL


def timer(name: str, **ids) -> _Open:
    """A span that always reads the clock: its ``seconds`` after exit."""
    return _Open(name, ids, _recording())


def record(name: str, t0: float, t1: float, clock: str = "host",
           **ids) -> None:
    """Add a finished span measured elsewhere, under the span open on this
    thread (nothing while not recording)."""
    if not _recording():
        return
    st = _REC.stack()
    parent = st[-1] if st else None
    window = ids.pop("window", parent.window if parent else None)
    _REC.spans.append(Span(next(_REC.ids), name, t0, t1,
                           threading.get_ident(),
                           parent.id if parent else None, window, clock,
                           ids))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _REC.counts[name] = _REC.counts.get(name, 0) + n


def spans() -> List[Span]:
    """The finished spans (the newest ``MAX_SPANS``), in the order they
    finished."""
    return list(_REC.spans)


def counts() -> Dict[str, int]:
    return dict(_REC.counts)


def clear() -> None:
    """Forget every span and counter."""
    _REC.spans.clear()
    _REC.counts.clear()
