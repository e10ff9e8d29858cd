"""The card's idle share of the traced window: one less the union of
device operation intervals (profiler, CUPTI) over the window."""
NAME, UNIT = "device_idle_share.steady", "%"


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
