"""ckpt_snapshot_ms: mean of the checkpoint saver's ``snapshot_s`` (the
serving thread's synchronised device-to-host copy of the carry) over the
measured span's windows."""
from perfbench.core.stats import mean


def read(rd):
    m = mean(rd.counters.get("ckpt_snapshot_s", []))
    return None if m is None else m * 1e3
