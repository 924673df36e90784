"""The cell sift10m-anonysys-bulk through the harness at a CPU size (2,000
documents: one big-tier partition and the rest in the chunk engine), and
its readers of the partitioned layout's spans and counters."""

import pytest

from rbacbench import manifest, roofline, trace
from vectorsearch_rbac_tpu_torch.utils import tracing

CELL = "sift10m-anonysys-bulk"
HOST_READERS = ("big_enqueue_ms", "route_ms", "fanout_merge_ms",
                "probes_per_query")


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# one call: route 0-50, two big-tier launches, the chunk engine's launch,
# the big tier's copy back, then the merge
EVENTS = [
    _x("user_annotation", "rbacbench.traced", 0, 1000),
    _x("user_annotation", "rbacbench.call", 0, 1000),
    _x("user_annotation", "tiled.search_batch", 1, 998),
    _x("user_annotation", "tiled.route", 1, 49),
    _x("user_annotation", "tiled.big_enqueue", 50, 100),
    _x("user_annotation", "tiled.chunk_scan", 150, 150),
    _x("user_annotation", "tiled.big_fetch", 300, 600),
    _x("user_annotation", "tiled.merge", 900, 80),
    _x("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 100, 5, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 850, 5, corr=4),
    _x("cuda_runtime", "cudaLaunchKernel", 950, 5, corr=5),
    _x("kernel", "void scan_tc_kernel<32>(int)", 70, 300, corr=1),
    _x("kernel", "void extract_pairs_kernel(int)", 370, 100, corr=2),
    _x("kernel", "void tiled_scan(int)", 470, 200, corr=3),
    _x("gpu_memcpy", "Memcpy DtoH", 860, 20, corr=4),
    _x("kernel", "void outside(int)", 960, 10, corr=5),
]


def _read(name, summary):
    return manifest.reader("metrics", name).read(summary)


def test_tiled_roofline_reads_the_three_spans_device_time():
    s = trace.summarize(EVENTS)
    s.kind = "NVIDIA H100 80GB HBM3"
    s.work = [dict(n_rows=1000, n_docs=10, dim=128, words=4, queries=10,
                   k=10, admitted=2500)]
    least = roofline.least_s(s.kind, s.work)
    # 300 + 100 (big_enqueue), 200 (chunk_scan), 20 (big_fetch); the
    # merge's launch is outside them
    assert _read("tiled_roofline_pct", s) == pytest.approx(
        100 * least / 620e-6)
    assert _read("route_ms", s) == pytest.approx(0.049)
    assert _read("big_enqueue_ms", s) == pytest.approx(0.1)
    assert _read("fanout_merge_ms", s) == pytest.approx(0.08)


@pytest.mark.parametrize("name", ["tiled_roofline_pct", "big_enqueue_ms",
                                  "route_ms", "fanout_merge_ms"])
def test_readers_none_without_the_partitioned_spans(name):
    """The global RLS path opens none of the tiled spans."""
    s = trace.summarize([ev for ev in EVENTS
                         if not ev["name"].startswith("tiled.")])
    s.kind = "NVIDIA H100 80GB HBM3"
    s.work = [dict(n_rows=1000, n_docs=10, dim=128, words=4, queries=10,
                   k=10, admitted=2500)]
    assert _read(name, s) is None


@pytest.mark.parametrize("counts,want", [
    ({"tiled.queries": 8192, "tiled.probes": 8192}, 1.0),
    ({"tiled.queries": 8192, "tiled.probes": 12288}, 1.5),
    ({"tiled.queries": 8192}, None),
    ({"tiled.probes": 8192}, None),
    ({"tiled.queries": 0, "tiled.probes": 0}, None),
    ({"flat_int8.queries": 8192, "flat_int8.positions": 10240}, None),
])
def test_probes_per_query(monkeypatch, counts, want):
    monkeypatch.setattr(tracing, "COUNTS", dict(counts))
    got = _read("probes_per_query", trace.summarize(EVENTS))
    assert got == (None if want is None else pytest.approx(want))


def test_probes_per_query_none_without_the_registry(monkeypatch):
    monkeypatch.delattr(tracing, "COUNTS")
    assert _read("probes_per_query", trace.summarize(EVENTS)) is None


def test_tiny_traced_cell_is_correct_and_reads_the_layout():
    """The cell cut to 2,000 documents: the harness judges every answer
    correct, and the traced line reports the route, enqueue, merge and
    fan-out of the partitioned layout (on the CPU the trace has no device
    time, so no roofline share)."""
    from tiny_cell import run_tiny, tiny_cell

    tracing.reset_counts()
    line = run_tiny(tiny_cell(CELL, rows=199_966), traced=True)
    assert line["correct"], line["checks"]
    assert line["checks"]["invalid_rows"]["value"] == 0
    got = {name: line["metrics"][name]["value"] for name in HOST_READERS}
    assert got["big_enqueue_ms"] > 0 and got["route_ms"] > 0
    assert got["fanout_merge_ms"] > 0
    assert 1.0 <= got["probes_per_query"] <= 3.0


def _entry():
    return manifest.generator("entries", "planned_searcher")


def test_within_returns_what_fits_its_budget():
    assert _entry().within(5.0, lambda: 42) == 42


def test_within_stops_work_past_its_budget():
    import time

    def spin():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 10.0:
            pass

    t0 = time.perf_counter()
    with pytest.raises(_entry().PlanTimeout):
        _entry().within(0.2, spin)
    assert time.perf_counter() - t0 < 5.0


def test_within_refuses_late_work_off_the_main_thread():
    import threading
    import time

    got = {}

    def late():
        try:
            _entry().within(0.01, lambda: time.sleep(0.1))
        except _entry().PlanTimeout as e:
            got["err"] = e

    t = threading.Thread(target=late)
    t.start()
    t.join()
    assert isinstance(got.get("err"), _entry().PlanTimeout)


def test_a_planner_past_the_budget_fails_the_run_before_the_arena(
        monkeypatch):
    """A program whose planner cannot plan the world within the
    configuration's `plan_seconds` fails the run at the budget, and builds
    no arena."""
    import time

    from tiny_cell import run_tiny, tiny_cell
    from vectorsearch_rbac_tpu_torch import core
    from vectorsearch_rbac_tpu_torch.partition import dynamic

    def slow_plan(world, inputs, refine_heavy=True):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30.0:
            pass

    def no_arena(*a, **kw):
        raise AssertionError("the arena was built after a refused plan")

    monkeypatch.setattr(dynamic, "plan_dynamic_partitions", slow_plan)
    monkeypatch.setattr(core, "build_device_arena", no_arena)
    cell = tiny_cell(CELL, rows=40_066)
    cell.config["port"]["plan_seconds"] = 0.5
    t0 = time.perf_counter()
    with pytest.raises(_entry().PlanTimeout):
        run_tiny(cell)
    assert time.perf_counter() - t0 < 25.0


def test_the_entry_plans_only_the_dynamic_strategy():
    from tiny_cell import run_tiny, tiny_cell

    cell = tiny_cell(CELL, rows=40_066)
    cell.config["port"]["strategy"] = "rls"
    with pytest.raises(ValueError, match="dynamic"):
        run_tiny(cell)
