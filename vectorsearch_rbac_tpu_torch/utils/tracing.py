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
- `COUNTS`, `count(name, n)`, `reset_counts()` (the port's own): counters
  at layer boundaries, process-wide. `Int8FlatIndex.search_deferred`
  counts `flat_int8.queries` (the caller's queries) and
  `flat_int8.positions` (the query positions its scan runs: admit-dedup's
  slot pads and the tail included) once a pass, and
  `TiledSearcher.search_batch` counts `tiled.queries`, `tiled.probes`,
  `tiled.big_searches`, `tiled.slots` and `tiled.chunk_dispatches` once a
  call (partition/tiled.py). The kernel wrappers' launch counts are
  `ops/_build.LAUNCHES`.

The program's spans are `torch.profiler.record_function` ranges, on the
profiler's clock beside the device rows of the same trace. On the global
RLS path one `search_batch` call opens `partitioned.search_batch` (the
whole call), inside it `flat_int8.user_table` (the uid wire's table digest,
the upload on a miss), `flat_int8.masks` (the host mask rows),
`flat_int8.dedup`, `flat_int8.quantize_upload` (its children
`flat_int8.quantize`, the host quantizer, and `flat_int8.upload`, the
host-to-device copies and the slot reorder), `flat_int8.enqueue` (per
dispatch `.scan`, `.merge`, `.rerank`, `.wire`) and, in finalize(),
`flat_int8.fetch_unpack` (its children `flat_int8.fetch`, the wait and
the device-to-host copy, and `flat_int8.unpack`, the host unpack of the
wire rows).
"""

from __future__ import annotations

import contextlib
import os
import threading
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


COUNTS: Dict[str, int] = {}
_COUNTS_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` in COUNTS."""
    with _COUNTS_LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + n


def reset_counts() -> None:
    with _COUNTS_LOCK:
        COUNTS.clear()
