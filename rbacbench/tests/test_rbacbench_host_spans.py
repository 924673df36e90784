"""The host-span and counter readers (host_serial_ms, quantize_ms,
unpack_ms, scan_pad_pct) on a hand-made trace and hand-set counters."""

import pytest

from rbacbench import manifest, trace
from vectorsearch_rbac_tpu_torch.utils import tracing

SPAN_READERS = ("host_serial_ms", "quantize_ms", "unpack_ms")


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _call(t0):
    """One call of 1,000 us: 100 of enqueue, 600 of fetch, 30 of quantize
    and 40 of unpack inside it."""
    return [_span("rbacbench.call", t0, 1000),
            _span("partitioned.search_batch", t0 + 1, 998),
            _span("flat_int8.quantize_upload", t0 + 10, 80),
            _span("flat_int8.quantize", t0 + 10, 30),
            _span("flat_int8.upload", t0 + 40, 50),
            _span("flat_int8.enqueue", t0 + 100, 100),
            _span("flat_int8.fetch_unpack", t0 + 250, 700),
            _span("flat_int8.fetch", t0 + 250, 600),
            _span("flat_int8.unpack", t0 + 850, 40)]


EVENTS = ([_span("rbacbench.traced", 0, 2000)] + _call(0) + _call(1000))


def _read(name, summary):
    return manifest.reader("metrics", name).read(summary)


def test_span_readers_per_call():
    s = trace.summarize(EVENTS)
    assert s.calls == 2
    assert _read("host_serial_ms", s) == pytest.approx((998 - 100 - 600)
                                                       * 1e-3)
    assert _read("quantize_ms", s) == pytest.approx(0.03)
    assert _read("unpack_ms", s) == pytest.approx(0.04)


@pytest.mark.parametrize("missing", ["partitioned.search_batch",
                                     "flat_int8.enqueue", "flat_int8.fetch",
                                     "flat_int8.quantize", "flat_int8.unpack"])
def test_span_readers_none_without_their_span(missing):
    s = trace.summarize([ev for ev in EVENTS if ev["name"] != missing])
    needs = {"host_serial_ms": ("partitioned.search_batch",
                                "flat_int8.enqueue", "flat_int8.fetch"),
             "quantize_ms": ("flat_int8.quantize",),
             "unpack_ms": ("flat_int8.unpack",)}
    for name in SPAN_READERS:
        got = _read(name, s)
        assert (got is None) == (missing in needs[name]), name


def test_span_readers_none_without_calls():
    s = trace.summarize([ev for ev in EVENTS
                         if ev["name"] != "rbacbench.call"])
    for name in SPAN_READERS:
        assert _read(name, s) is None


@pytest.mark.parametrize("counts,want", [
    ({"flat_int8.queries": 8192, "flat_int8.positions": 10240}, 25.0),
    ({"flat_int8.queries": 8192, "flat_int8.positions": 8192}, 0.0),
    ({"flat_int8.queries": 3 * 8192, "flat_int8.positions": 2 * 10240
      + 8192}, 100.0 * 4096 / (3 * 8192)),
    ({"flat_int8.queries": 8192}, None),
    ({"flat_int8.positions": 10240}, None),
    ({"flat_int8.queries": 0, "flat_int8.positions": 0}, None),
    ({}, None),
])
def test_scan_pad_pct(monkeypatch, counts, want):
    monkeypatch.setattr(tracing, "COUNTS", dict(counts))
    got = _read("scan_pad_pct", trace.summarize(EVENTS))
    assert got == (None if want is None else pytest.approx(want))


def test_scan_pad_pct_none_without_the_registry(monkeypatch):
    """A program without the counters (the registry absent) reads None."""
    monkeypatch.delattr(tracing, "COUNTS")
    assert _read("scan_pad_pct", trace.summarize(EVENTS)) is None


def test_tiny_traced_line_reads_the_host_metrics():
    """A traced run of the cell cut to the CPU's size reports the four
    metrics: the program opens the spans and counts its passes."""
    from tiny_cell import run_tiny, tiny_cell

    tracing.reset_counts()
    line = run_tiny(tiny_cell(), traced=True)
    got = {name: line["metrics"][name]["value"] for name in
           SPAN_READERS + ("scan_pad_pct",)}
    assert got["host_serial_ms"] > 0 and got["quantize_ms"] > 0
    assert got["unpack_ms"] > 0 and 0 <= got["scan_pad_pct"] <= 25.0
