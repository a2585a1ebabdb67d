"""kernels_per_slot: kernel runs the card recorded (CUPTI, through
torch.profiler) in the traced span, per slot served in it."""


def read(rd):
    slots = rd.counters.get("trace_slots")
    if rd.device is None or not slots:
        return None
    return len(rd.device.kernels) / slots
