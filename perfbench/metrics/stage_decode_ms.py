"""stage_decode_ms: p50 over the traced slots of the card's time in the
server detector's decode (scores, candidates, NMS, scaling to the frame):
the interval between the detector's end mark and the decode's
(``stage.decode`` device spans).

Read in the run's profiled windows."""
from perfbench.core.spans import PROFILED, span_p50_ms


def read(rd):
    return span_p50_ms(rd, "stage.decode", part=PROFILED)
