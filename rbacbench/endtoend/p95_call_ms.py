"""p95_call_ms: the 95th percentile of every call of the window, each from
just before the search to its host arrays in hand (numpy's linear
percentile)."""

import numpy as np


def read(run):
    walls = [c.t1 - c.t0 for c in run.window.calls]
    return float(np.percentile(walls, 95)) * 1000.0
