"""The port's serving front-end and result cache on the CPU: the
BatchingServer's results equal a direct search_batch (concurrent clients,
coalesced batches), mixed k is grouped and close() serves what is queued;
the closed-loop driver counts and answers every request it sends;
the CachedSearcher gives the reference's hits, misses and ids over the
same batches (both wrapping searchers on one arena state); the serving
sweep names its knee by the reference script's rule."""

import threading

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.bench.result_cache import (
    CachedSearcher as RefCachedSearcher)
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import synthetic_corpus as ref_synthetic
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch.bench.result_cache import CachedSearcher
from vectorsearch_rbac_tpu_torch.bench.serving import knees
from vectorsearch_rbac_tpu_torch.config import FrameworkConfig
from vectorsearch_rbac_tpu_torch.data import synthetic_corpus
from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator
from vectorsearch_rbac_tpu_torch.serving import BatchingServer, closed_loop

WORLD = dict(num_users=120, num_roles=24, num_docs=200, h=3, b0=2, b1=3,
             seed=7)
CORPUS = dict(num_docs=200, blocks_per_doc=4, dim=32, seed=3)


@pytest.fixture(scope="module")
def served():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    rworld = RefTreeGenerator(**WORLD).generate()
    rarena = ref_arena(ref_synthetic(**CORPUS), rworld, block_rows=128)
    world = TreeRBACGenerator(**WORLD).generate()
    corpus = synthetic_corpus(**CORPUS)
    arena = arena_from_reference(rarena, "cpu")
    cfg, rcfg = FrameworkConfig(), RefFrameworkConfig()
    for c in (cfg, rcfg):
        c.search.block_rows = 128
        c.index.kind = "flat"
    yield (world, corpus, arena, build_searcher("rls", corpus, world, arena,
                                                cfg),
           rworld, ref_searcher("role", ref_synthetic(**CORPUS), rworld,
                                rarena, rcfg),
           build_searcher("role", corpus, world, arena, cfg))
    torch.set_num_threads(prev)


def test_serving_matches_direct_batch(served):
    world, corpus, _, searcher = served[:4]
    rng = np.random.default_rng(0)
    nq = 64
    q = rng.standard_normal((nq, corpus.dim)).astype(np.float32)
    uids = rng.integers(0, world.num_users, nq)
    want_d, want_i = searcher.search_batch(q, uids, world.user_masks, 5)
    results, errors = [None] * nq, []
    with BatchingServer(searcher, world.user_masks, max_batch=16,
                        max_wait_ms=5.0) as srv:
        def client(lo, hi):
            try:
                tickets = [srv.submit(q[j], uids[j], 5)
                           for j in range(lo, hi)]
                for j, t in zip(range(lo, hi), tickets):
                    results[j] = t.result(timeout=60)
            except BaseException as e:   # surfaced by the assert below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(s, s + 16))
                   for s in range(0, nq, 16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats()
    assert not errors
    np.testing.assert_array_equal(np.stack([r.row_ids for r in results]),
                                  want_i)
    np.testing.assert_array_equal(np.stack([r.dists for r in results]),
                                  want_d)
    assert stats["served"] == nq
    assert stats["dispatches"] < nq and stats["avg_batch"] > 1.0
    assert stats["max_batch"] <= 16
    assert all(r.latency_ms > 0 and 1 <= r.batch_size <= 16
               for r in results)


def test_serving_mixed_k_and_close_drains(served):
    world, corpus, arena, searcher = served[:4]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((8, corpus.dim)).astype(np.float32)
    uids = rng.integers(0, world.num_users, 8)
    srv = BatchingServer(searcher, world.user_masks, max_batch=8,
                         max_wait_ms=50.0)
    tickets = [srv.submit(q[j], uids[j], 3 if j % 2 else 7)
               for j in range(8)]
    srv.close()   # serves everything queued before it stops
    for j, t in enumerate(tickets):
        r = t.result(timeout=1)
        k = 3 if j % 2 else 7
        assert r.row_ids.shape == (k,)
        want = searcher.search_batch(q[j:j + 1], uids[j:j + 1],
                                     world.user_masks, k)[1][0]
        np.testing.assert_array_equal(r.row_ids, want)
        for rid in r.row_ids[r.row_ids >= 0]:
            assert (arena.host_bits[rid] & world.user_masks[uids[j]]).any()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(q[0], int(uids[0]), 3)


def test_serving_propagates_errors(served):
    world, corpus, _, searcher = served[:4]
    with BatchingServer(searcher, world.user_masks) as srv:
        bad = srv.submit(np.zeros(corpus.dim + 3, np.float32), 0, 5)
        with pytest.raises(Exception):
            bad.result(timeout=30)
        ok = srv.search(np.zeros(corpus.dim, np.float32), 0, 5, timeout=30)
        assert ok.row_ids.shape == (5,)


def test_cached_searcher_matches_reference(served):
    world, corpus, _, _, rworld, rsearch, searcher = served
    mine = CachedSearcher(searcher, world, capacity=24)
    ref = RefCachedSearcher(rsearch, rworld, capacity=24)
    assert mine.name == ref.name == "role+cache"
    rng = np.random.default_rng(4)
    base = rng.standard_normal((20, corpus.dim)).astype(np.float32)
    for step in range(4):
        pick = rng.integers(0, 20, 16)     # repeats across and within
        q = base[pick]
        uids = rng.integers(0, world.num_users, 16)
        uids[:4] = uids[4:8]               # same user: within-batch hits
        q[:4] = q[4:8]
        got = mine.search_batch(q, uids, world.user_masks, 5)
        want = ref.search_batch(q, uids, rworld.user_masks, 5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        assert mine.stats() == ref.stats(), step
    assert mine.stats()["hits"] > 0 and mine.stats()["entries"] <= 24
    assert mine.storage_report() == searcher.storage_report()


def test_serving_sweep_names_the_knee():
    def lv(c, w, qps, p99):
        return {"clients": c, "max_wait_ms": w, "qps": qps, "p99_ms": p99}

    levels = [lv(1, 3.0, 100, 2), lv(64, 3.0, 5000, 9),
              lv(256, 3.0, 9000, 20), lv(512, 3.0, 9300, 45),
              lv(1024, 3.0, 9400, 90), lv(64, 25.0, 4000, 30),
              lv(256, 25.0, 8000, 40)]
    assert knees(levels) == {"3.0": 256, "25.0": None}


def test_serving_under_thread_stress(served):
    """More client threads than cores, a short switch interval: every
    request is answered once, with its own query's ids, and close()
    leaves no request behind."""
    import sys

    world, corpus, _, searcher = served[:4]
    rng = np.random.default_rng(6)
    n_threads, per = 32, 6
    q = rng.standard_normal((n_threads * per, corpus.dim)).astype(np.float32)
    uids = rng.integers(0, world.num_users, len(q))
    want = searcher.search_batch(q, uids, world.user_masks, 4)[1]
    got = [None] * len(q)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        srv = BatchingServer(searcher, world.user_masks, max_batch=24,
                             max_wait_ms=1.0)

        def client(t):
            for j in range(t * per, (t + 1) * per):
                got[j] = srv.search(q[j], int(uids[j]), 4, timeout=60)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        srv.close()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not srv._thread.is_alive()
    np.testing.assert_array_equal(np.stack([r.row_ids for r in got]), want)
    assert srv.stats()["served"] == len(q)


def test_closed_loop_answers_every_request(served):
    """closed_loop (the CLI's serve and bench.serving): each of its
    clients' draws is answered with the ids of a direct search_batch on
    that request, and the report counts them all."""
    world, corpus, _, searcher = served[:4]
    pool = np.random.default_rng(8).standard_normal(
        (32, corpus.dim)).astype(np.float32)
    sent = []
    lock = threading.Lock()

    def draw(r):
        j, u = int(r.integers(0, len(pool))), int(r.integers(
            0, world.num_users))
        with lock:
            sent.append((j, u))
        return pool[j], u

    with BatchingServer(searcher, world.user_masks, max_batch=8,
                        max_wait_ms=2.0) as srv:
        rep, got = closed_loop(srv, draw, 4, 4, 0.3, seed0=11)
    assert rep["requests"] == len(got) == len(sent) > 0
    assert rep["dispatches"] >= 1 and rep["wall_s"] >= 0.3
    assert rep["qps"] == rep["requests"] / rep["wall_s"]
    assert rep["p50_ms"] <= rep["p95_ms"] <= rep["p99_ms"]
    want = {}
    for j, u in set(sent):
        want[(j, u)] = searcher.search_batch(pool[j:j + 1], np.asarray([u]),
                                             world.user_masks, 4)[1][0]
    answers = {u: {tuple(want[(j, uu)]) for j, uu in set(sent) if uu == u}
               for _, u in sent}
    for u, ids in got:
        assert tuple(ids) in answers[u]
