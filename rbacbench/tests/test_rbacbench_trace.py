"""The trace reduction and the per-layer readers on a hand-made trace."""

import pytest

from rbacbench import manifest, roofline, trace


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


EVENTS = [
    _x("user_annotation", "rbacbench.traced", 0, 1000),
    _x("user_annotation", "rbacbench.call", 5, 995),
    _x("user_annotation", "flat_int8.quantize_upload", 10, 90),
    _x("user_annotation", "flat_int8.enqueue", 100, 100),
    _x("user_annotation", "flat_int8.scan", 110, 20),
    _x("user_annotation", "flat_int8.fetch_unpack", 200, 800),
    _x("cuda_runtime", "cudaMemcpyAsync", 50, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 115, 5, corr=2),
    _x("cuda_driver", "cuLaunchKernelEx", 150, 5, corr=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 210, 5, corr=4),
    _x("gpu_memcpy", "Memcpy HtoD", 60, 40, corr=1),
    # two streams overlapping: 200-700 and 600-800 cover 200-800 once
    _x("kernel", "void scan_tc_kernel<4>(CUtensorMap)", 200, 500, corr=2),
    _x("kernel", "void extract_pairs_kernel(int)", 600, 200, corr=3),
    _x("gpu_memcpy", "Memcpy DtoH", 900, 50, corr=4),
    _x("cpu_op", "aten::add", 0, 1000),
]


def test_summary_spans_union_and_gaps():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(1e-3)
    assert s.calls == 1
    # device: 60-100, 200-800, 900-950
    assert s.busy_s == pytest.approx(690e-6)
    assert s.span_host_s["flat_int8.fetch_unpack"] == pytest.approx(800e-6)
    assert s.span_device_s["flat_int8.scan"] == pytest.approx(500e-6)
    assert s.span_device_s["flat_int8.enqueue"] == pytest.approx(700e-6)
    assert s.span_device_s["flat_int8.quantize_upload"] == pytest.approx(
        40e-6)
    assert s.kernel_s(r"\bscan_\w*kernel\b") == pytest.approx(500e-6)
    gaps = dict(s.idle_gaps)
    # before the HtoD copy (launched in quantize_upload), before the scan
    # (launched in scan), before the DtoH copy and after it (fetch_unpack)
    assert gaps == pytest.approx({"flat_int8.quantize_upload": 60e-6,
                                  "flat_int8.scan": 100e-6,
                                  "flat_int8.fetch_unpack": 150e-6})
    b = trace.breakdown(s)
    assert b["device_ops"][0][0].startswith("void scan_tc_kernel")
    assert len(b["device_ops"]) <= trace.TOP


def test_readers():
    s = trace.summarize(EVENTS)
    s.kind = "NVIDIA H100 80GB HBM3"
    s.work = [dict(n_rows=1000, n_docs=10, dim=128, words=4, queries=10,
                   k=5, admitted=2500)]
    least = roofline.bound_s(129_640, 640_000,
                             *roofline.peaks(s.kind))[0]
    read = {name: manifest.reader("metrics", name).read(s) for name in (
        "quantize_upload_ms", "fetch_unpack_ms", "scan_roofline_pct",
        "search_roofline_pct", "device_idle_pct")}
    assert read["quantize_upload_ms"] == pytest.approx(0.09)
    assert read["fetch_unpack_ms"] == pytest.approx(0.8)
    assert read["scan_roofline_pct"] == pytest.approx(100 * least / 500e-6)
    assert read["search_roofline_pct"] == pytest.approx(100 * least / 700e-6)
    assert read["device_idle_pct"] == pytest.approx(31.0)


def test_readers_find_nothing_to_read():
    s = trace.summarize([_x("user_annotation", "rbacbench.traced", 0, 10)])
    s.kind = "cpu"
    for name in ("quantize_upload_ms", "fetch_unpack_ms",
                 "scan_roofline_pct", "search_roofline_pct",
                 "device_idle_pct"):
        assert manifest.reader("metrics", name).read(s) is None
