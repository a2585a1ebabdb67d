"""The program's spans, as the per-layer readers of ``program_span``
metrics see them.

The port records spans (``repro_torch.common.trace``) while a profiler
session records, so in a traced run the recorder holds the traced
windows and nothing else.  A reader takes them from
``repro_torch.common.trace.spans()``, or from the recorder the readings
carry under ``counters["span_recorder"]`` (the CPU tests' synthetic one:
any object whose ``spans()`` returns records with ``name``, ``t0``,
``t1`` and ``window``).  A program without the recorder gives no spans,
and every reader then finds nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from perfbench.core.stats import mean, percentile

WINDOW = "stream.window"


def program_spans(rd) -> List:
    rec = rd.counters.get("span_recorder")
    if rec is None:
        try:
            from repro_torch.common import trace as rec
        except ImportError:         # a program from before the recorder
            return []
    return list(rec.spans())


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


def window_stat_ms(rd, name: str, stat: str = "p50") -> Optional[float]:
    """The p50 (or mean) over the traced windows of the spans ``name``
    summed per window, in ms."""
    wins = per_window_s(program_spans(rd), name)
    if wins is None:
        return None
    vals = list(wins.values())
    v = mean(vals) if stat == "mean" else percentile(vals, 50)
    return None if v is None else 1e3 * v


def span_p50_ms(rd, name: str) -> Optional[float]:
    """The p50 of the spans ``name``, each on its own, in ms."""
    p = percentile([sp.t1 - sp.t0 for sp in program_spans(rd)
                    if sp.name == name], 50)
    return None if p is None else 1e3 * p
