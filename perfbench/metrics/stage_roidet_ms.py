"""stage_roidet_ms: p50 over the traced slots of the card's time in the
slot's ROIDet (the light detector, the block motion and the labels): the
interval between two of the episode graph's stage marks (``stage.roidet``
device spans).

Read in the run's profiled windows."""
from perfbench.core.spans import PROFILED, span_p50_ms


def read(rd):
    return span_p50_ms(rd, "stage.roidet", part=PROFILED)
