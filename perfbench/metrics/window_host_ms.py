"""window_host_ms: p50 over the recorded windows of the serving thread's
own work in a window: the program's ``stream.window`` span less its
``harvest.wait`` (the host waiting for the card) and its ``ckpt.wait``
(waiting for the previous checkpoint write).

Read in the windows that a traced run serves with the program's recorder
on and no profiler, before the profiled ones: with CUPTI recording every
kernel node of a graph replay, the replays' launch takes tens of ms a
window against about 1.4 ms untraced on an H100."""
from perfbench.core.spans import HOST, WINDOW, per_window_s, program_spans
from perfbench.core.stats import percentile


def read(rd):
    spans = program_spans(rd, HOST)
    whole = per_window_s(spans, WINDOW)
    if whole is None:
        return None
    waits = [per_window_s(spans, n) for n in ("harvest.wait", "ckpt.wait")]
    own = [s - sum(w[k] for w in waits) for k, s in whole.items()]
    return 1e3 * percentile(own, 50)
