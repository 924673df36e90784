"""scan_roofline_pct: the least time of the traced calls' filtered search
(roofline.py) over the device time of the scan kernels, by name (K1,
its slot form, the wide scan: scan_*kernel)."""

from rbacbench import roofline

SCAN = r"\bscan_\w*kernel\b"


def read(trace):
    least, dev = roofline.least_s(trace.kind, trace.work), trace.kernel_s(SCAN)
    if least is None or not dev:
        return None
    return 100.0 * least / dev
