"""stage_synth_ms: p50 over the traced slots of the card's time in the slot's
synthesis (the scene's frames and their noise): the interval between two
of the episode graph's stage marks (``stage.synth`` device spans).

Read in the run's profiled windows."""
from perfbench.core.spans import PROFILED, span_p50_ms


def read(rd):
    return span_p50_ms(rd, "stage.synth", part=PROFILED)
