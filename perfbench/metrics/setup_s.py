"""setup_s: process start to the first measured window (host clock):
imports, the CUDA context, kernel libraries, the warm-up's captures."""


def read(rd):
    return rd.total("setup")
