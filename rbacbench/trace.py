"""Reduce a torch.profiler trace of a few calls to what the readers take.

The span arithmetic follows vectorsearch_rbac_tpu_torch/bench/profile.py
`profile_pass` at commit 67fd89a: a span's host time is the summed length
of its ranges; its device time is the summed time of the kernels, copies
and sets whose launch the host made inside the span's range, nested spans
included. The launch ties a device event to its span through the launch
call with the same correlation id (cudaLaunchKernel, cuLaunchKernelEx, a
copy), so kernels launched through ctypes, which belong to no torch op,
count too. The one fix: the
device's busy time is the union of the device intervals, not their sum,
so work on two streams at once counts once.

Trace timestamps are microseconds on the profiler's clock.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
WINDOW_SPAN = "rbacbench.traced"
CALL_SPAN = "rbacbench.call"
TOP = 10


@dataclass
class TraceSummary:
    window_s: float                       # the traced window's length
    busy_s: float                         # union of device intervals
    calls: int                            # calls traced
    span_host_s: Dict[str, float]         # span -> summed host seconds
    span_device_s: Dict[str, float]       # span -> device seconds inside
    device_ops: Dict[str, float]          # device op -> summed seconds
    idle_gaps: List[Tuple[str, float]]    # (host span, idle seconds)
    work: List[dict] = field(default_factory=list)   # per traced call
    kind: str = ""                        # the card's name

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the device ops whose name matches pattern."""
        rx = re.compile(pattern)
        return sum(s for name, s in self.device_ops.items()
                   if rx.search(name))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(spans, t: float) -> Optional[str]:
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else None


def summarize(events: List[dict]) -> TraceSummary:
    """The summary of a Chrome trace's events, over the WINDOW_SPAN range
    (the whole trace where it has none)."""
    spans, launches, device = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == SPAN_CAT:
            spans.append((ev["name"], ts, ts + dur))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            device.append((ev["name"], ts, ts + dur,
                           ev.get("args", {}).get("correlation")))
    win = [(s, e) for n, s, e in spans if n == WINDOW_SPAN]
    if win:
        w0, w1 = min(s for s, _ in win), max(e for _, e in win)
    else:
        pts = [s for _, s, _ in spans] + [s for _, s, _, _ in device]
        ends = [e for _, _, e in spans] + [e for _, _, e, _ in device]
        w0, w1 = (min(pts), max(ends)) if pts else (0.0, 0.0)
    device = [d for d in device if d[2] > w0 and d[1] < w1]
    span_host: Dict[str, float] = {}
    for name, s, e in spans:
        span_host[name] = span_host.get(name, 0.0) + (e - s) * 1e-6
    span_dev: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for name, s, e, corr in device:
        sec = (min(e, w1) - max(s, w0)) * 1e-6
        ops[name] = ops.get(name, 0.0) + sec
        t = launches.get(corr)
        if t is None:
            continue
        for sname in {n for n, s0, e0 in spans if s0 <= t < e0}:
            span_dev[sname] = span_dev.get(sname, 0.0) + sec
    busy = _union([(max(s, w0), min(e, w1)) for _, s, e, _ in device])
    # a gap is labelled by the span that launched the work ending it (the
    # host was still inside or before that launch), the window's last gap
    # by the span the host was in when the device went idle
    first_launch = {}
    for _, s, _, corr in sorted(device, key=lambda d: d[1]):
        t = launches.get(corr)
        if t is not None:
            first_launch.setdefault(max(s, w0), t)
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            t = first_launch.get(g1, g0)
            label = _innermost(spans, t) or "host"
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        calls=sum(1 for n, s, e in spans if n == CALL_SPAN
                  and s >= w0 and e <= w1),
        span_host_s=span_host, span_device_s=span_dev, device_ops=ops,
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def profiler():
    """A torch.profiler of CPU and, where a card is present, CUDA
    activity, to run as a context manager around the traced calls."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events(prof) -> List[dict]:
    """The finished profiler's Chrome trace events. The trace goes through
    a file in the temporary directory, removed once read; call it after
    the measured window, since writing and reading take seconds."""
    fd, path = tempfile.mkstemp(prefix="rbacbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def breakdown(summary: TraceSummary) -> dict:
    """The result line's breakdown: the device ops that took most time
    and the idle time by the host span that was running, TOP of each."""
    ops = sorted(summary.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[name[:160], sec] for name, sec in ops],
            "idle_gaps": [[name, sec] for name, sec
                          in summary.idle_gaps[:TOP]]}
