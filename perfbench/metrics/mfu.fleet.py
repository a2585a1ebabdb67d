"""mfu.fleet: the detectors' convolution FLOPs of every camera-slot served
in the measured window, over the window's seconds and the card's peak in
the precision the convolutions ran in (TF32 where cuDNN may use it, else
float32), in %."""
from perfbench.core.flops import fleet_slot_flops
from perfbench.core.peaks import FLOPS_PER_S


def read(rd):
    window = rd.total("window")
    cam_slots = rd.counters.get("camera_slots")
    if not window or not cam_slots:
        return None
    peak = FLOPS_PER_S["tf32" if rd.counters.get("cudnn_allow_tf32")
                       else "float32"]
    return 100.0 * fleet_slot_flops(rd.cell.config) * cam_slots / window \
        / peak
