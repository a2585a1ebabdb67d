"""stage_detect_ms: p50 over the traced slots of the card's time in the
slot's server detector (the letterbox, the forward and DFL; on the side
stream, beside the next slot's front): the interval between the finish's
first two stage marks (``stage.detect`` device spans).

Read in the run's profiled windows."""
from perfbench.core.spans import PROFILED, span_p50_ms


def read(rd):
    return span_p50_ms(rd, "stage.detect", part=PROFILED)
