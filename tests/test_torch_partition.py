"""The port's partitioned strategies (ROLE, USER, AnonySys) against the
JAX reference on the same small world.

Both packages build the world and the SIFT-like corpus from the same
seeds with their own code (tests/test_torch_host.py holds those equal);
the port's arena comes from the reference's through arena_from_reference
and its AnonySys plan, where a test says so, through plan_from_reference.
The reference runs as its own tests run it on the CPU (Pallas in
interpret mode, the chunk engine in XLA); the port runs its plain
versions. Results are compared per query: the distance lists equal, the
ids equal at every distance (as sets among ties)."""

import numpy as np
import pytest

import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.index.flat_int8 import (
    Int8FlatIndex as RefInt8FlatIndex)
from vectorsearch_rbac_tpu.ops.topk import merge_topk_host as ref_merge
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.partition.tiled import (
    TiledSearcher as RefTiledSearcher)
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch.index.flat_int8 import Int8FlatIndex
from vectorsearch_rbac_tpu_torch.ops.topk import merge_topk_host
from vectorsearch_rbac_tpu_torch.partition import TiledSearcher
from vectorsearch_rbac_tpu_torch.partition.dynamic import plan_from_reference
from test_torch_packed import one_thread  # noqa: F401

WORLD = dict(num_users=80, num_roles=16, num_docs=120, h=3, b0=2, b1=2,
             seed=5)
CORPUS = dict(num_vectors=1200, dim=32, blocks_per_doc=10, seed=4)
NQ, K = 40, 8


@pytest.fixture(scope="module")
def ref():
    world = RefTreeGenerator(**WORLD).generate()
    corpus, _ = ref_corpus(**CORPUS)
    arena = ref_arena(corpus, world, block_rows=256, dtype="int8")
    return corpus, world, arena


@pytest.fixture(scope="module")
def mine(ref):
    world = port.TreeRBACGenerator(**WORLD).generate()
    corpus, _ = port.sift_like_corpus(**CORPUS)
    return corpus, world, arena_from_reference(ref[2], "cpu")


@pytest.fixture(scope="module")
def queries(ref):
    corpus, world, _ = ref
    rng = np.random.default_rng(9)
    qf = rng.integers(0, 256, (NQ, corpus.dim)).astype(np.float32)
    users = rng.integers(0, world.num_users, NQ)
    return qf, users


def _cfgs(scan_group=32, alpha=1.5, batch=256):
    out = []
    for cfg in (RefFrameworkConfig(), port.FrameworkConfig()):
        cfg.index.kind = "flat_approx"
        cfg.search.scan_group = scan_group
        cfg.search.batch_size = batch
        cfg.optimizer.storage_alpha = alpha
        out.append(cfg)
    return out


def assert_same_results(got, want):
    """Per query: equal distance lists, and at every distance the same ids
    (as sets: tied rows may come in another order)."""
    (gd, gi), (wd, wi) = got, want
    assert gi.shape == wi.shape
    np.testing.assert_array_equal(np.asarray(gd, np.float64),
                                  np.asarray(wd, np.float64))
    for q in range(len(gi)):
        for v in np.unique(wd[q]):
            assert set(gi[q][gd[q] == v]) == set(wi[q][wd[q] == v]), (q, v)


def assert_readable(corpus, world, ids, users, masks=None):
    masks = world.user_masks if masks is None else masks
    bits = corpus.vector_role_bits(world)
    for q, u in enumerate(users):
        for r in ids[q][ids[q] >= 0]:
            assert (bits[r] & masks[u]).any(), (q, r)


@pytest.mark.parametrize("name,scan_group", [
    ("role", 0), ("role", 8), ("user", 8), ("dynamic", 0), ("dynamic", 8)])
def test_strategy_matches_reference(ref, mine, queries, name, scan_group):
    """ROLE, USER and AnonySys through build_searcher: the chunk engine at
    the exact (0) and the grouped (8) epilogue, the fan-out merge of ROLE
    and AnonySys; AnonySys plans with the port's own planner."""
    rc, rw, ra = ref
    mc, mw, ma = mine
    rcfg, mcfg = _cfgs(scan_group)
    qf, users = queries
    want_s = ref_searcher(name, rc, rw, ra, rcfg)
    got_s = build_searcher(name, mc, mw, ma, mcfg)
    assert isinstance(got_s, TiledSearcher)
    assert sorted(got_s.part_chunks) == sorted(want_s.part_chunks)
    assert got_s.storage_report()["num_partitions"] == \
        want_s.storage_report()["num_partitions"]
    want = want_s.search_batch(qf, users, rw.user_masks, K)
    got = got_s.search_batch(qf, users, mw.user_masks, K)
    assert_same_results(got, want)
    assert (got[1] >= 0).sum() > 0.5 * got[1].size
    assert_readable(mc, mw, got[1], users)


def test_reference_plan_carries_over(ref, mine, queries):
    """The reference's AnonySys plan, fed in through plan_from_reference,
    builds the same partitions and gives the same results."""
    rc, rw, ra = ref
    mc, mw, ma = mine
    rcfg, mcfg = _cfgs(8, alpha=2.0)
    want_s = ref_searcher("dynamic", rc, rw, ra, rcfg)
    plan = plan_from_reference(want_s.plan)
    assert plan.assignment == want_s.plan.assignment
    got_s = build_searcher("dynamic", mc, mw, ma, mcfg, plan=plan)
    assert got_s.plan is plan
    qf, users = queries
    assert_same_results(got_s.search_batch(qf, users, mw.user_masks, K),
                        want_s.search_batch(qf, users, rw.user_masks, K))


def test_zero_role_users_get_empty_rows(ref, mine):
    """A user without roles routes nowhere: -1 ids, +inf distances, on both
    sides (tests/test_int8.py:260)."""
    rc, rw, ra = ref
    mc, mw, ma = mine
    rcfg, mcfg = _cfgs()
    masks = mw.user_masks.copy()
    masks[0] = 0
    qf = np.zeros((3, mc.dim), np.float32)
    users = np.array([0, 1, 0])
    for name in ("user", "role", "dynamic"):
        s = build_searcher(name, mc, mw, ma, mcfg)
        d, i = s.search_batch(qf, users, masks, 5)
        want = ref_searcher(name, rc, rw, ra, rcfg).search_batch(
            qf, users, masks, 5)
        assert_same_results((d, i), want)
        assert ((i[0] == -1) | (d[0] < np.inf)).all()
        assert_readable(mc, mw, i, users, masks)


def _big_tier(arena, cls, logical, n):
    """A two-tier searcher: pid 0 (800 rows) in the big tier, pid 1 in
    the chunk engine."""
    rows = {0: np.arange(0, 800, dtype=np.int64),
            1: np.arange(800, n, dtype=np.int64)}
    # the reference sizes its role one-hots by num_roles; the port's
    # bitsets need no such width
    extra = dict(num_roles=16) if cls is RefTiledSearcher else {}
    return cls(arena, rows, lambda uid: (0, 1), "mixed", chunk_rows=256,
               big_chunks=2, big_group=8, big_logical=logical, **extra)


@pytest.mark.parametrize("logical", [False, True], ids=["gathered", "logical"])
def test_big_tier_matches_reference(ref, mine, logical):
    """The big tier (an Int8FlatIndex over the partition's rows at group
    8, gathered or logical) beside the chunk engine, with the fan-out
    merge: 16 queries of many masks (per query), then 256 queries of 4
    masks, 64 each, where admit-dedup groups them into slots on both
    sides."""
    rc, rw, ra = ref
    mc, mw, ma = mine
    want_s = _big_tier(ra, RefTiledSearcher, logical, rc.n)
    got_s = _big_tier(ma, TiledSearcher, logical, mc.n)
    assert list(got_s._big) == list(want_s._big) == [0]
    big, want_big = got_s._big[0], want_s._big[0]
    assert big.group == want_big.group == 8
    assert big._row_map.shape[0] == want_big._row_map.shape[0] == 8192
    rng = np.random.default_rng(21)
    for nq, users in ((16, rng.integers(0, rw.num_users, 16)),
                      (256, rng.permutation(np.repeat([3, 40, 77, 5],
                                                      64)))):
        qf = rng.integers(0, 256, (nq, rc.dim)).astype(np.float32)
        want = want_s.search_batch(qf, users, rw.user_masks, 5)
        got = got_s.search_batch(qf, users, mw.user_masks, 5)
        assert big._last_dedup == want_big._last_dedup == (nq == 256)
        assert_same_results(got, want)
        assert_readable(mc, mw, got[1], users)
    # the gathered tier keeps its padded int8 rows, the logical one only
    # its row map
    assert big.storage_bytes()["vectors"] == (0 if logical else 8192 * 128)
    assert big.storage_bytes()["index"] >= 8192 * 4


@pytest.mark.parametrize("logical", [False, True], ids=["gathered", "logical"])
def test_partition_index_admit_dedup(ref, mine, logical):
    """Int8FlatIndex over a row subset with admit-dedup on and off: the
    gate fires where the reference's does, the results equal the
    reference's, and on equals off bit for bit (skewed mask counts pad
    slots; a broad mask population stays per query)."""
    rc, rw, ra = ref
    mc, mw, ma = mine
    rows = np.arange(100, 1100, dtype=np.int64)
    rng = np.random.default_rng(11)
    nq = 320
    qf = rng.integers(0, 256, (nq, rc.dim)).astype(np.float32)
    base = rng.choice(rw.num_users, 5, replace=False)
    skewed = base[np.minimum((rng.pareto(1.2, nq) * 2).astype(int), 4)]
    broad = rng.integers(0, rw.num_users, nq)
    kw = dict(query_batch=128, q_tile=128, block_rows=256, group=8,
              logical=logical)
    want_ix = RefInt8FlatIndex(ra, rows, dist16=False, **kw)
    on = Int8FlatIndex(ma, rows, **kw)
    off = Int8FlatIndex(ma, rows, mask_dedup=False, **kw)
    for users in (skewed, broad):
        masks = mw.user_masks[users]
        want = want_ix.search(qf, rw.user_masks[users], K)
        got_on = on.search(qf, masks, K)
        assert on._last_dedup == want_ix._last_dedup
        got_off = off.search(qf, masks, K)
        assert not off._last_dedup
        np.testing.assert_array_equal(got_on[0], got_off[0])
        np.testing.assert_array_equal(got_on[1], got_off[1])
        assert_same_results(got_on, want)
        assert set(np.unique(got_on[1])) <= set(rows) | {-1}
    assert on._last_dedup is False            # the broad population
    on.search(qf, mw.user_masks[skewed], K)
    assert on._last_dedup is True


def _dedup_slots_loop(masks, sb, bs):
    """The reference's grouping (flat_int8.py:583-616) as it is written,
    np.unique and a loop over slots, with slots laid out contiguously."""
    nq = len(masks)
    _, minv = np.unique(masks, axis=0, return_inverse=True)
    counts = np.bincount(minv.ravel())
    s_tot = int(np.sum(-(-counts // sb)))
    npq2 = -(-(s_tot * sb) // bs) * bs
    if npq2 > max(bs, int(1.25 * (-(-nq // bs) * bs))):
        return None
    order = np.argsort(minv.ravel(), kind="stable")
    src, valid = np.zeros(npq2, np.int64), np.zeros(npq2, bool)
    ptr = slot = 0
    for c in counts:
        qs = order[ptr:ptr + c]
        ptr += int(c)
        for s0 in range(0, int(c), sb):
            chunk = qs[s0:s0 + sb]
            idx = slot * sb + np.arange(sb)
            src[idx] = chunk[0]
            src[idx[:len(chunk)]] = chunk
            valid[idx[:len(chunk)]] = True
            slot += 1
    return src, valid


@pytest.mark.parametrize("n_masks,nq,sb,bs", [
    (5, 320, 16, 128), (100, 8192, 16, 2048), (3, 1000, 8, 256),
    (40, 300, 16, 128), (1, 64, 16, 64)])
def test_dedup_slots_equal_the_reference_loop(n_masks, nq, sb, bs):
    """The vectorized grouping lays out exactly what the reference's loop
    does (uint32 words with the top bit set included), and declines where
    it declines."""
    from vectorsearch_rbac_tpu_torch.index.flat_int8 import dedup_slots

    rng = np.random.default_rng(n_masks + nq)
    pool = rng.integers(0, 2**32, (n_masks, 4), dtype=np.uint64).astype(
        np.uint32)
    pool[:, 0] |= np.uint32(1 << 31)
    masks = pool[rng.integers(0, n_masks, nq)]
    got, want = dedup_slots(masks, sb, bs), _dedup_slots_loop(masks, sb, bs)
    assert (got is None) == (want is None) == (n_masks == 40)
    if got is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_partition_index_refuses_ids_wire(mine):
    with pytest.raises(ValueError, match="rank pseudo-distances"):
        Int8FlatIndex(mine[2], np.arange(10), wire="ids")


def test_unpacked_layout_matches_reference(ref, mine, queries):
    """packed=False: one Int8FlatIndex per partition (rows gathered, the
    f32 wire), enqueued together and merged per tuple of partitions."""
    from vectorsearch_rbac_tpu.partition.strategies import (
        build_role_searcher as ref_role)
    from vectorsearch_rbac_tpu_torch.partition import build_role_searcher

    rc, rw, ra = ref
    mc, mw, ma = mine
    rcfg, mcfg = _cfgs()
    qf, users = queries
    want = ref_role(rc, rw, ra, rcfg, packed=False).search_batch(
        qf, users, rw.user_masks, K)
    s = build_role_searcher(mc, mw, ma, mcfg, packed=False)
    assert len(s.partitions) > 1
    got = s.search_batch(qf, users, mw.user_masks, K)
    assert_same_results(got, want)


def test_merge_topk_host_identical():
    """The copied host merge: duplicate rows keep their best distance,
    empties pad, ties keep their order."""
    rng = np.random.default_rng(4)
    ds = [np.sort(rng.integers(0, 20, (30, 6)).astype(np.float32), axis=1)
          for _ in range(3)]
    ids = [rng.integers(-1, 40, (30, 6)) for _ in range(3)]
    for d, i in zip(ds, ids):
        d[i < 0] = np.inf
    for k in (4, 10, 25):
        got, want = merge_topk_host(ds, ids, k), ref_merge(ds, ids, k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        ok = got[1][got[1] >= 0]
        assert len(ok) == sum(len(set(r[r >= 0])) for r in got[1])


def test_unported_strategies_and_metrics_raise(mine, queries, one_thread):
    """Index kind ivf (queue 1 item 10) now builds and serves AnonySys, an
    IVFIndex a partition (the unpacked layout), every row readable; HNSW
    (queue 1 item 11) now builds under RLS, ROLE and USER too, and kind
    "hybrid", the AnonySys graph executor's, is an unknown index kind
    there, as in the reference."""
    from vectorsearch_rbac_tpu_torch.index.ivf import IVFIndex

    mc, mw, ma = mine
    qf, users = queries
    _, cfg = _cfgs()
    cfg.index.kind = "ivf"
    cfg.index.ivf_nlist = 8
    cfg.search.nprobe = 8
    s = build_searcher("dynamic", mc, mw, ma, cfg)
    assert all(isinstance(p.index, IVFIndex) for p in s.partitions.values())
    _, ids = s.search_batch(qf, users, mw.user_masks, K)
    assert (ids >= 0).sum() > 0.5 * ids.size
    assert_readable(mc, mw, ids, users)
    # at full probe each partition's IVF scan is exact: the flat-scan
    # AnonySys of the same plan returns the same rows
    cfg.index.kind = "flat_approx"
    cfg.search.scan_group = 0
    flat = build_searcher("dynamic", mc, mw, ma, cfg, plan=s.plan)
    np.testing.assert_array_equal(
        np.sort(ids, 1), np.sort(flat.search_batch(qf, users, mw.user_masks,
                                                   K)[1], 1))
    # HNSW builds a graph over the arena or each partition and serves;
    # "hybrid" outside AnonySys is refused before any build
    from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
    for name in ("rls", "role", "user"):
        cfg.index.kind = "hnsw"
        s = build_searcher(name, mc, mw, ma, cfg)
        assert all(isinstance(p.index, HNSWIndex)
                   for p in s.partitions.values())
        _, ids = s.search_batch(qf, users, mw.user_masks, K)
        assert (ids >= 0).sum() > 0.5 * ids.size
        assert_readable(mc, mw, ids, users)
        cfg.index.kind = "hybrid"
        with pytest.raises(ValueError, match="unknown index kind"):
            build_searcher(name, mc, mw, ma, cfg)
