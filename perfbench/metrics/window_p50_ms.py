"""window_p50_ms: median over every window of the measured span, offer()
to the return of serve() (host clock)."""
from perfbench.core.stats import percentile


def read(rd):
    p = percentile(rd.durations("serve_window"), 50)
    return None if p is None else p * 1e3
