"""device.idle_share: the share of the traced window in which no kernel,
copy or memory set ran on the device, on any stream."""


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
