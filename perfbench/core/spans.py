"""The program's spans, as the per-layer readers of ``program_span``
metrics see them.

The port records spans (``repro_torch.common.trace``) while a profiler
session records or after ``trace.enable()``.  A traced run of the fleet
stream (``drivers/fleet_stream.py``) serves two parts, each a few windows
long: first windows with the recorder on and no profiler, whose host spans
are the untraced program's (``HOST``), then the profiled windows, whose
device marks the stage readers take (``PROFILED``).  It keeps what the
recorder holds after them under ``counters["span_recorder"]`` and the
window ids of each part under ``counters["span_windows"]``.  A reader
takes the spans of its part's windows; where the readings name no parts
(the CPU tests' synthetic recorder: any object whose ``spans()`` returns
records with ``name``, ``t0``, ``t1`` and ``window``), it takes them all.
Readings without a recorder (an untraced run) have no spans, and every
reader then finds nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from perfbench.core.stats import mean, percentile

WINDOW = "stream.window"
HOST = "host"
PROFILED = "profiled"


class Recorded:
    """Spans kept from the program's recorder, read as the recorder
    reads."""

    def __init__(self, spans):
        self._spans = list(spans)

    def spans(self) -> List:
        return list(self._spans)


def program_spans(rd, part: Optional[str] = None) -> List:
    """The program's spans; with ``part``, those of that part's windows
    where the readings name the parts."""
    rec = rd.counters.get("span_recorder")
    if rec is None:
        return []
    spans = list(rec.spans())
    windows = rd.counters.get("span_windows", {}).get(part)
    if windows is None:
        return spans
    keep = set(windows)
    return [sp for sp in spans if sp.window in keep]


def per_window_s(spans: List, name: str) -> Optional[Dict[int, float]]:
    """Seconds of the spans ``name`` summed per window, for every window
    that has a ``stream.window`` span (0 where it has none of them); None
    without windows."""
    wins = {sp.window: 0.0 for sp in spans if sp.name == WINDOW}
    if not wins:
        return None
    for sp in spans:
        if sp.name == name and sp.window in wins:
            wins[sp.window] += sp.t1 - sp.t0
    return wins


def window_stat_ms(rd, name: str, stat: str = "p50",
                   part: Optional[str] = None) -> Optional[float]:
    """The p50 (or mean) over ``part``'s windows of the spans ``name``
    summed per window, in ms."""
    wins = per_window_s(program_spans(rd, part), name)
    if wins is None:
        return None
    vals = list(wins.values())
    v = mean(vals) if stat == "mean" else percentile(vals, 50)
    return None if v is None else 1e3 * v


def span_p50_ms(rd, name: str, part: Optional[str] = None
                ) -> Optional[float]:
    """The p50 of the spans ``name`` in ``part``'s windows, each on its
    own, in ms."""
    p = percentile([sp.t1 - sp.t0 for sp in program_spans(rd, part)
                    if sp.name == name], 50)
    return None if p is None else 1e3 * p
