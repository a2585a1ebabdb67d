"""ckpt_write_ms: p50 over the traced saves of the program's ``ckpt.write``
span: the writer thread's compress, data fsync, manifest, commit and
gc of one checkpoint."""
from perfbench.core.spans import span_p50_ms


def read(rd):
    return span_p50_ms(rd, "ckpt.write")
