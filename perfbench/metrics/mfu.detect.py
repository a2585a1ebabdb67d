"""mfu.detect: the server detector's share of the card's peak while it
runs, in %: the FLOPs of a slot's detector batch (cameras x
``eval_frames`` frames at the architecture module's ``flops(config)``,
``perfbench/reference/detectors/``) over the p50 of the ``stage.detect``
device spans and the peak in the precision the convolutions ran in (TF32
where cuDNN may use it, else float32).

Read in the run's profiled windows."""
from perfbench.core.peaks import FLOPS_PER_S
from perfbench.core.spans import PROFILED, span_p50_ms


def read(rd):
    from perfbench.reference.detectors import server_module
    ms = span_p50_ms(rd, "stage.detect", part=PROFILED)
    if not ms:
        return None
    cfg = rd.cell.config
    frames = int(cfg["scene"]["num_cameras"]) * int(
        cfg["system"]["eval_frames"])
    flops = frames * server_module(
        cfg, rd.cell.bench_dir / "reference" / "detectors").flops(cfg)
    peak = FLOPS_PER_S["tf32" if rd.counters.get("cudnn_allow_tf32")
                       else "float32"]
    return 100.0 * flops / (1e-3 * ms) / peak
