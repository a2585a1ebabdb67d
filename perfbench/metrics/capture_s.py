"""capture_s: the warm-up windows, which capture the episode's CUDA graphs
(host clock, synchronised on both sides)."""


def read(rd):
    return rd.total("capture")
