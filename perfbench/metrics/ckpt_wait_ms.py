"""ckpt_wait_ms: mean over the traced windows of the program's
``ckpt.wait`` spans in a window: the serving thread waiting for the
previous checkpoint write (intermittent, hence the mean)."""
from perfbench.core.spans import window_stat_ms


def read(rd):
    return window_stat_ms(rd, "ckpt.wait", "mean")
