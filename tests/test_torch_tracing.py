"""The port's spans and counters on the global RLS path, on the small world
of test_torch_uid_table.py, run on the CPU (the kernels' plain versions).

One `search_batch` opens the root span partitioned.search_batch and, inside
it, the index's host spans once each; the children of
flat_int8.quantize_upload and flat_int8.fetch_unpack lie inside their
parents. The counters flat_int8.queries and flat_int8.positions (utils/
tracing.py COUNTS) differ by admit-dedup's padding exactly."""

import sys
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from vectorsearch_rbac_tpu_torch import build_device_arena, build_searcher
from vectorsearch_rbac_tpu_torch.bench import make_scenario, serving_config
from vectorsearch_rbac_tpu_torch.index.flat_int8 import (MASK_SB,
                                                         Int8FlatIndex,
                                                         dedup_slots)
from vectorsearch_rbac_tpu_torch.utils import tracing

N, NQ, K = 16384, 512, 10
BATCH = 128          # admit-dedup's batch: 512 queries, 4 batches unpadded
NEW_SPANS = ("partitioned.search_batch", "flat_int8.user_table",
             "flat_int8.masks", "flat_int8.quantize", "flat_int8.upload",
             "flat_int8.fetch", "flat_int8.unpack")
PARENT = {"flat_int8.user_table": "partitioned.search_batch",
          "flat_int8.masks": "partitioned.search_batch",
          "flat_int8.dedup": "partitioned.search_batch",
          "flat_int8.quantize_upload": "partitioned.search_batch",
          "flat_int8.enqueue": "partitioned.search_batch",
          "flat_int8.fetch_unpack": "partitioned.search_batch",
          "flat_int8.quantize": "flat_int8.quantize_upload",
          "flat_int8.upload": "flat_int8.quantize_upload",
          "flat_int8.fetch": "flat_int8.fetch_unpack",
          "flat_int8.unpack": "flat_int8.fetch_unpack"}


@pytest.fixture(scope="module")
def small():
    corpus, world, workload = make_scenario(n=N, num_queries=NQ, topk=K)
    arena = build_device_arena(corpus, world, device="cpu", block_rows=N,
                               dtype="int8")
    searcher = build_searcher("rls", None, world, arena,
                              serving_config(block_rows=N, batch=BATCH,
                                             topk=K, wire="ids"))
    # four users of distinct masks, 120/130/131/131 queries: 35 slots of
    # 16, 640 positions for 512 queries, inside the 1.25x gate
    _, first = np.unique(world.user_masks, axis=0, return_index=True)
    four = np.sort(first)[:4]
    users = np.random.default_rng(3).permutation(
        np.repeat(four, [120, 130, 131, 131]))
    return world, workload, arena, searcher, users


def _spans(prof):
    """{span name: [(start us, end us)]} of the profiled program spans."""
    out = {}
    for ev in prof.events():
        if ev.name.startswith(("flat_int8.", "partitioned.")):
            out.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return out


def _profiled_call(small):
    world, workload, _, searcher, users = small
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = searcher.search_batch(workload.vectors, users,
                                    world.user_masks, K)
    return _spans(prof), out


def test_search_batch_opens_each_new_span_once(small):
    spans, _ = _profiled_call(small)
    index = small[3].partitions[0].index
    assert index._last_uid_wire and index._last_dedup
    for name in NEW_SPANS:
        assert len(spans.get(name, [])) == 1, name
    assert "flat_int8.gather" not in spans


def test_child_spans_lie_inside_their_parents(small):
    spans, _ = _profiled_call(small)
    for child, parent in PARENT.items():
        ((c0, c1),) = spans[child]
        ((p0, p1),) = spans[parent]
        assert p0 <= c0 <= c1 <= p1, (child, parent)


def test_ids_equal_with_the_profiler_on_and_off(small):
    world, workload, _, searcher, users = small
    _, (d_on, i_on) = _profiled_call(small)
    d_off, i_off = searcher.search_batch(workload.vectors, users,
                                         world.user_masks, K)
    np.testing.assert_array_equal(i_on, i_off)
    np.testing.assert_array_equal(d_on, d_off)


def test_counts_of_a_padded_pass_differ_by_its_padding(small):
    world, workload, _, searcher, users = small
    src, _ = dedup_slots(world.user_masks[users], MASK_SB, BATCH)
    assert len(src) > NQ
    tracing.reset_counts()
    searcher.search_batch(workload.vectors, users, world.user_masks, K)
    assert searcher.partitions[0].index._last_dedup
    counts = tracing.COUNTS
    assert counts["flat_int8.queries"] == NQ
    assert counts["flat_int8.positions"] - counts["flat_int8.queries"] \
        == len(src) - NQ


def test_counts_without_admit_dedup_are_equal(small):
    world, workload, arena, _, users = small
    index = Int8FlatIndex(arena, query_batch=BATCH, block_rows=N,
                          wire="ids", mask_dedup=False)
    tracing.reset_counts()
    index.search(workload.vectors, world.user_masks[users], K)
    index.search(workload.vectors[:100], world.user_masks[users[:100]], K)
    assert not index._last_dedup
    assert tracing.COUNTS["flat_int8.queries"] == NQ + 100
    assert tracing.COUNTS["flat_int8.positions"] == NQ + 100


def test_reset_counts_zeroes_both(small):
    world, workload, _, searcher, users = small
    searcher.search_batch(workload.vectors[:64], users[:64],
                          world.user_masks, K)
    assert tracing.COUNTS["flat_int8.queries"] > 0
    tracing.reset_counts()
    for name in ("flat_int8.queries", "flat_int8.positions"):
        assert tracing.COUNTS.get(name, 0) == 0


def test_count_adds_under_threads():
    """Read-modify-write under the lock: no update is lost when threads
    count at once."""
    tracing.reset_counts()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [tracing.count("t.n") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert tracing.COUNTS["t.n"] == 16 * 2000
    tracing.reset_counts()
