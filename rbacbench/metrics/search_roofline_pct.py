"""search_roofline_pct: the least time of the traced calls' filtered
search (roofline.py) over the device time of every operation launched
inside the program's span flat_int8.enqueue: scans, merges, wire."""

from rbacbench import roofline


def read(trace):
    least = roofline.least_s(trace.kind, trace.work)
    dev = trace.span_device_s.get("flat_int8.enqueue")
    if least is None or not dev:
        return None
    return 100.0 * least / dev
