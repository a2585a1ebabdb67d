"""mfu.fleet: the detectors' FLOPs (the light detector's and the
configuration's server detector's, ``perfbench/core/flops.py``) of every
camera-slot served in the measured window, over the window's seconds and
the card's peak in the precision the convolutions ran in (TF32 where
cuDNN may use it, else float32), in %."""
from perfbench.core.flops import fleet_slot_flops
from perfbench.core.peaks import FLOPS_PER_S


def read(rd):
    window = rd.total("window")
    cam_slots = rd.counters.get("camera_slots")
    if not window or not cam_slots:
        return None
    peak = FLOPS_PER_S["tf32" if rd.counters.get("cudnn_allow_tf32")
                       else "float32"]
    flops = fleet_slot_flops(rd.cell.config, rd.cell.bench_dir)
    return 100.0 * flops * cam_slots / window / peak
