"""stage_encode_ms: p50 over the traced slots of the card's time in the
slot's encode (the codec keys, keep, compaction and the codec): the
interval between two of the episode graph's stage marks (``stage.encode``
device spans).

Read in the run's profiled windows."""
from perfbench.core.spans import PROFILED, span_p50_ms


def read(rd):
    return span_p50_ms(rd, "stage.encode", part=PROFILED)
