"""nms_overflow_frames: frames, summed over the traced slots, whose NMS
kept fewer than 16 boxes while more anchors passed the threshold than
the candidates it took (the program's ``nms.overflow_frames`` counter, a
slot's count on its ``stage.decode`` span): frames where the first 16
kept boxes may differ from a full NMS's.

Read in the run's profiled windows."""
from perfbench.core.spans import PROFILED, program_spans


def read(rd):
    counts = [sp.ids.get("overflow_frames") for sp in
              program_spans(rd, PROFILED) if sp.name == "stage.decode"]
    counts = [n for n in counts if n is not None]
    return float(sum(counts)) if counts else None
