"""window_p95_ms: 95th percentile over every window of the measured span,
from the offer() of its first slot to the return of the serve() that
served it (host clock)."""
from perfbench.core.stats import percentile


def read(rd):
    p = percentile(rd.durations("serve_window"), 95)
    return None if p is None else p * 1e3
