"""camera_slots_per_s: cameras times slots whose logs came back in the
measured window, over the window's whole length (host clock)."""


def read(rd):
    window = rd.total("window")
    if not window or "camera_slots" not in rd.counters:
        return None
    return rd.counters["camera_slots"] / window
