"""stage_finish_ms: p50 over the traced slots of the card's time in the
slot's finish (the server detector, box decode and F1; on the side stream,
beside the next slot's front): the interval between two of the episode
graph's stage marks (``stage.finish`` device spans).

Read in the run's profiled windows."""
from perfbench.core.spans import PROFILED, span_p50_ms


def read(rd):
    return span_p50_ms(rd, "stage.finish", part=PROFILED)
