"""harvest_wait_ms: p50 over the traced windows of the program's
``harvest.wait`` spans in a window: the host blocked on the card at the
episode's first log fetch.

Read only in the run's profiled windows: CUPTI records every kernel node
of a graph replay there, which slows the replays' launch on the host
(tens of ms a window against about 1.4 ms untraced on an H100) and
shortens the wait on the card to match.  The value is the profiled
window's, CUPTI's cost included, and not the untraced program's."""
from perfbench.core.spans import window_stat_ms


def read(rd):
    return window_stat_ms(rd, "harvest.wait")
