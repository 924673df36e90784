"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the device (the union of their intervals)."""


def read(trace):
    if not trace.window_s or not trace.busy_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
