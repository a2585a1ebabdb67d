"""kernel_roofline: the hand-written kernels' time-weighted share of their
roofline in the traced span, in %: the sum of each launch's bound (bytes
and operations from the launch's shape, ``perfbench/core/kernel_cost.py``)
over the sum of their recorded times."""
from perfbench.core.kernel_cost import KERNEL_NAMES, launch_bound_s


def read(rd):
    shapes = rd.counters.get("kernel_shapes")
    if rd.device is None or not shapes:
        return None
    bound = spent = 0.0
    for name, seconds in rd.device.kernels:
        for kernel, frag in KERNEL_NAMES.items():
            if frag in name and kernel in shapes:
                bound += launch_bound_s(kernel, shapes[kernel])
                spent += seconds
                break
    return 100.0 * bound / spent if spent > 0 else None
