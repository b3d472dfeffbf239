"""device_idle_pct: the share of the profiled blocks' wall time in which no
kernel, copy or fill ran on the card (1 - union of device intervals / wall),
in percent. Layer: the device."""

RANGES = ()


def read(t):
    if t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
