"""tiled_roofline_pct: the least time of the traced calls' filtered search
(roofline.py, the same work whatever layout serves it) over the device
time of everything the program launched inside its spans
tiled.big_enqueue (the big tier's scans and merges), tiled.chunk_scan
(the chunk engine) and tiled.big_fetch (the big tier's copies back)."""

from rbacbench import roofline

SPANS = ("tiled.big_enqueue", "tiled.chunk_scan", "tiled.big_fetch")


def read(trace):
    least = roofline.least_s(trace.kind, trace.work)
    dev = sum(trace.span_device_s.get(name, 0.0) for name in SPANS)
    if least is None or not dev:
        return None
    return 100.0 * least / dev
