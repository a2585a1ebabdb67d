"""ckpt_write_ms: p50 over the recorded windows' saves of the program's
``ckpt.write`` span: the writer thread's compress, data fsync, manifest,
commit and gc of one checkpoint.

Read in the windows that a traced run serves with the program's recorder
on and no profiler, before the profiled ones: with CUPTI recording every
kernel node of a graph replay, the replays' launch takes tens of ms a
window against about 1.4 ms untraced on an H100."""
from perfbench.core.spans import HOST, span_p50_ms


def read(rd):
    return span_p50_ms(rd, "ckpt.write", part=HOST)
