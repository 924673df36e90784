"""Stage timers, device traces and named spans.

Counterpart of vectorsearch_rbac_tpu/utils/tracing.py:

- `StageTimer` / `StageStats` (copies): wall-clock seconds per named
  stage, with counts, totals and percentiles. The partitioned searchers
  keep one as `.timer` (stages route, device_scan, merge; the
  TiledSearcher also big_enqueue and quantize), beside the
  torch.profiler spans that `bench/profile.py` reads.
- `device_trace(log_dir)`: a torch.profiler trace of the CPU and, on a
  card, CUDA activity, written to log_dir as a Chrome trace. The
  reference's jax.profiler trace turns into a no-op where the profiler
  cannot start; this one raises.
- `annotate(name)`: a named span in device traces (`record_function`,
  and an NVTX range when a card is present).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import numpy as np
import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    samples: List[float] = field(default_factory=list)

    def summary(self) -> Dict[str, float]:
        s = np.asarray(self.samples) if self.samples else np.zeros(1)
        return {
            "count": self.count,
            "total_s": self.total_s,
            "mean_ms": self.total_s / max(self.count, 1) * 1000,
            "p50_ms": float(np.percentile(s, 50)) * 1000,
            "p95_ms": float(np.percentile(s, 95)) * 1000,
        }


class StageTimer:
    """Wall time per named stage. Not thread-safe (one per engine; the
    serving front-end calls an engine from one thread)."""

    def __init__(self, max_samples: int = 4096):
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self.max_samples = max_samples

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            st = self.stages[name]
            st.count += 1
            st.total_s += dt
            if len(st.samples) < self.max_samples:
                st.samples.append(dt)

    def report(self) -> Dict[str, Dict[str, float]]:
        return {name: st.summary() for name, st in self.stages.items()}

    def reset(self) -> None:
        self.stages.clear()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block with torch.profiler (CPU, and CUDA where a card is
    present) and write log_dir/trace_<pid>_<ns>.json, a Chrome trace.
    Raises where the profiler cannot start or write."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span visible in device traces."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
