"""device_idle_share: the share of the traced span in which no kernel,
copy or set ran on the card, in %."""


def read(rd):
    dt = rd.device
    if dt is None or dt.window_s <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
