"""degraded_windows: windows of the measured span that the stream runner
served below its ``episode`` rung (its ``rung`` before each serve())."""


def read(rd):
    return rd.counters.get("degraded_windows")
