"""harvest_wait_ms: p50 over the recorded windows of the program's
``harvest.wait`` spans in a window: the host blocked on the card at the
episode's first log fetch.

Read in the windows that a traced run serves with the program's recorder
on and no profiler, before the profiled ones: with CUPTI recording every
kernel node of a graph replay, the replays' launch takes tens of ms a
window against about 1.4 ms untraced on an H100."""
from perfbench.core.spans import HOST, window_stat_ms


def read(rd):
    return window_stat_ms(rd, "harvest.wait", part=HOST)
