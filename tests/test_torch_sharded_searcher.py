"""The port's sharded searchers against the JAX reference's on the CPU:
ShardedGlobalSearcher (float32, bfloat16, int8), ShardedTiledSearcher
(parity and replication), ShardedGraphSearcher, build_dynamic_searcher's
mesh, and the BatchingServer over a sharded searcher (the counterpart of
tests/test_serving.py's).

The reference runs on the 8 virtual CPU devices of tests/conftest.py, its
Pallas kernels in interpret mode; the port on meshes of ["cpu"] * 8, its
kernels' plain versions, on the same world, corpus and arena
(arena_from_reference) or graphs (graph_state). Tolerances: float
distances to rtol 1e-5 of the case's largest (ids equal except among
distances within it, as sets: the ROADMAP tie rule); int8 and chunk
engine distances to 1e-5 (the reference's own bound between its sharded
and one-device engines) with ids equal in every query without ties;
graph ids equal array for array."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.index.hnsw import HNSWIndex as RefHNSWIndex
from vectorsearch_rbac_tpu.parallel import ShardedGraphSearcher as RefGraph
from vectorsearch_rbac_tpu.parallel import ShardedTiledSearcher as RefTiled
from vectorsearch_rbac_tpu.parallel import make_mesh as ref_make_mesh
from vectorsearch_rbac_tpu.parallel.searcher import (
    ShardedGlobalSearcher as RefGlobal)
from vectorsearch_rbac_tpu.partition.dynamic import (
    build_dynamic_searcher as ref_dynamic)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.config import FrameworkConfig
from vectorsearch_rbac_tpu_torch.data import synthetic_corpus
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.parallel import (ShardedGlobalSearcher,
                                                  ShardedGraphSearcher,
                                                  ShardedTiledSearcher,
                                                  make_mesh)
from vectorsearch_rbac_tpu_torch.partition import (GraphProbeBatcher,
                                                   TiledSearcher)
from vectorsearch_rbac_tpu_torch.partition.dynamic import (
    build_dynamic_searcher, plan_from_reference)
from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator
from vectorsearch_rbac_tpu_torch.serving import BatchingServer

CPU8 = ["cpu"] * 8
RTOL = 1e-5


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test (many small ops stall
    on a contended intra-op pool when other test workers share the
    cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mine():
    """The port's copies of conftest's small_world and small_corpus."""
    return (TreeRBACGenerator(num_users=120, num_roles=24, num_docs=200,
                              h=3, b0=2, b1=3, seed=7).generate(),
            synthetic_corpus(num_docs=200, blocks_per_doc=4, dim=32, seed=3))


def assert_same_topk(got, want, rtol=RTOL):
    """Equal empty slots; finite distances within rtol of the case's
    largest; per query, the ids strictly inside the k-th distance (less
    the tolerance) equal as sets."""
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    assert gd.shape == wd.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_array_equal(gi < 0, wi < 0)
    fin = np.isfinite(wd)
    if not fin.any():
        return
    tol = rtol * max(1.0, float(np.abs(wd[fin]).max()))
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=0, atol=tol)
    for q in range(len(wd)):
        ok = np.isfinite(wd[q])
        if not ok.any():
            continue
        last = wd[q][ok].max()
        assert (set(gi[q][np.isfinite(gd[q]) & (gd[q] < last - tol)])
                == set(wi[q][ok & (wd[q] < last - tol)])), q


def assert_close_untied_equal(got, want):
    """Distances within 1e-5; ids equal in every query whose distances
    hold no tie (the reference's rule between its engines)."""
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    ties = (wd[:, :-1] == wd[:, 1:]).any(axis=1)
    for qi in np.flatnonzero(~ties):
        np.testing.assert_array_equal(gi[qi], wi[qi])


def _draw(corpus, world, seed, nq):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, corpus.dim)).astype(np.float32)
    return q, rng.integers(0, world.num_users, nq)


# ---- ShardedGlobalSearcher


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_global_searcher_float(small_world, small_corpus, mine,
                                       dtype, one_thread):
    """4 shards x 2 replicas over the exact scan, against the reference's
    searcher on the same mesh shape; every row readable; the storage
    report's partitions are the shards."""
    world, corpus = mine
    ref = RefGlobal(small_corpus, small_world, n_devices=8, n_replicas=2,
                    block_rows=64, dtype=dtype, mode="exact")
    s = ShardedGlobalSearcher(corpus, world,
                              mesh=make_mesh(8, n_replicas=2, devices=CPU8),
                              block_rows=64, dtype=dtype)
    q, users = _draw(corpus, world, 2, 10)      # pads to the 2 replicas
    got = s.search_batch(q, users, world.user_masks, k=8)
    want = ref.search_batch(q, users, small_world.user_masks, k=8)
    assert_same_topk(got, want)
    bits = corpus.vector_role_bits(world)
    for qi, row in enumerate(got[1]):
        for r in row[row >= 0]:
            assert (bits[r] & world.user_masks[users[qi]]).any()
    assert s.storage_report()["num_partitions"] == 4
    assert (s.storage_report()["per_shard_mb"]
            == s.storage_report()["total_mb"] / 4)


def test_sharded_global_searcher_int8(small_world, small_corpus, mine,
                                      one_thread):
    """The int8 flagship over 4 shards x 2 replicas (group 8 a shard, the
    reference's rule) against the reference's: the same distances and
    ids; every row readable."""
    world, corpus = mine
    ref = RefGlobal(small_corpus, small_world, n_devices=8, n_replicas=2,
                    block_rows=128, dtype="int8")
    s = ShardedGlobalSearcher(corpus, world,
                              mesh=make_mesh(8, n_replicas=2, devices=CPU8),
                              block_rows=128, dtype="int8")
    assert s.quantized and s._int8_group() == ref._int8_group() == 8
    q, users = _draw(corpus, world, 4, 8)
    got = s.search_batch(q, users, world.user_masks, k=6)
    want = ref.search_batch(q, users, small_world.user_masks, k=6)
    assert_close_untied_equal(got, want)
    bits = corpus.vector_role_bits(world)
    for qi, row in enumerate(got[1]):
        for r in row[row >= 0]:
            assert (bits[r] & world.user_masks[users[qi]]).any()


# ---- ShardedTiledSearcher


def _role_partitions(corpus, world):
    parts = {}
    for role, docs in sorted(world.role_to_docs.items()):
        rows = corpus.rows_for_docs(
            np.fromiter(docs, dtype=np.int64, count=len(docs)))
        if len(rows):
            parts[role] = rows
    u2r = world.user_to_roles

    def router(uid):
        return tuple(r for r in u2r.get(uid, ()) if r in parts)

    return parts, router


@pytest.fixture(scope="module")
def arenas(small_world, small_corpus):
    ra = ref_arena(small_corpus, small_world, block_rows=128, dtype="int8")
    return ra, arena_from_reference(ra, "cpu")


def test_sharded_tiled_parity(small_world, small_corpus, mine, arenas,
                              one_thread):
    """Partitions placed over 8 devices by rows: the reference's
    placement, and the reference's sharded engine's and the port's
    one-device engine's results."""
    world, corpus = mine
    ra, pa = arenas
    parts, router = _role_partitions(corpus, world)
    weights = {pid: len(r) for pid, r in parts.items()}
    ref = RefTiled(ra, *_role_partitions(small_corpus, small_world),
                   ref_make_mesh(8, n_replicas=1), name="role_sharded",
                   chunk_rows=128, q_tile=8,
                   num_roles=small_world.num_roles,
                   partition_weights=weights)
    multi = ShardedTiledSearcher(pa, parts, router,
                                 make_mesh(8, devices=CPU8),
                                 name="role_sharded", chunk_rows=128,
                                 q_tile=8, partition_weights=weights)
    assert multi.placement == ref.placement
    assert len({d for devs in multi.placement.values() for d in devs}) > 1
    single = TiledSearcher(pa, parts, router, name="role", chunk_rows=128,
                           q_tile=8, scan_group=0)
    q, users = _draw(corpus, world, 6, 24)
    got = multi.search_batch(q, users, world.user_masks, k=8)
    assert_close_untied_equal(
        got, ref.search_batch(q, users, small_world.user_masks, k=8))
    assert_close_untied_equal(
        got, single.search_batch(q, users, world.user_masks, k=8))
    rep = multi.storage_report()
    assert rep["num_devices"] == 8 and rep["num_partitions"] == len(parts)


def test_sharded_tiled_replication(small_world, small_corpus, mine, arenas,
                                   one_thread):
    """The largest partition replicated on 4 devices, its query tiles in
    round-robin turns: the reference's distances."""
    world, corpus = mine
    ra, pa = arenas
    parts, router = _role_partitions(corpus, world)
    hot = max(parts, key=lambda p: len(parts[p]))
    ref = RefTiled(ra, *_role_partitions(small_corpus, small_world),
                   ref_make_mesh(4, n_replicas=1), name="role_rep",
                   chunk_rows=128, q_tile=8,
                   num_roles=small_world.num_roles, replicate=[hot])
    multi = ShardedTiledSearcher(pa, parts, router,
                                 make_mesh(4, devices=CPU8),
                                 name="role_rep", chunk_rows=128, q_tile=8,
                                 replicate=[hot])
    assert multi.placement[hot] == tuple(range(4)) == ref.placement[hot]
    q, users = _draw(corpus, world, 8, 16)
    got_d, _ = multi.search_batch(q, users, world.user_masks, k=8)
    want_d, _ = ref.search_batch(q, users, small_world.user_masks, k=8)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)


# ---- ShardedGraphSearcher


def test_sharded_graph_parity(small_world, small_corpus, mine, arenas,
                              one_thread):
    """Logical HNSW partitions (the reference's graphs, carried through
    graph_state) over 8 devices: ids equal to the reference's sharded
    searcher's and to the port's one-device batcher's, array for array,
    on the same probe jobs."""
    ra, pa = arenas
    world, corpus = mine
    ref_parts, parts = {}, {}
    for pid, role in enumerate(sorted(small_world.role_to_docs)):
        docs = small_world.role_to_docs[role]
        rows = small_corpus.rows_for_docs(
            np.fromiter(docs, dtype=np.int64, count=len(docs)))
        if len(rows) >= 40:
            ref_parts[pid] = RefHNSWIndex(ra, rows, m=8, ef_construction=48,
                                          seed=pid, logical=True)
            parts[pid] = HNSWIndex(pa, rows, m=8,
                                   graph_state=ref_parts[pid].graph_state(),
                                   logical=True)
        if len(parts) == 4:
            break
    assert len(parts) >= 2
    q, users = _draw(corpus, world, 7, 24)
    qmasks = world.user_masks[users].astype(np.uint32)
    jobs = [(pid, list(half), {"ef_search": 32, "max_steps": 48})
            for pid in parts for half in (range(12), range(12, 24))]
    ref_states = {pid: {"neighbors": np.asarray(ix._graph),
                        "entry": int(ix.entry),
                        "row_map": np.asarray(ix._row_map)}
                  for pid, ix in ref_parts.items()}
    want = RefGraph(ra, ref_states, ref_make_mesh(8, n_replicas=1)).run(
        q, qmasks, jobs, 5)
    states = {pid: {"neighbors": ix._hgraph, "entry": ix.entry,
                    "row_map": ix._hrmap} for pid, ix in parts.items()}
    sharded = ShardedGraphSearcher(pa, states, make_mesh(8, devices=CPU8))
    got = sharded.run(q, qmasks, jobs, 5)
    one = GraphProbeBatcher(pa, parts).run(q, qmasks, jobs, 5)
    for (gd, gi), (wd, wi), (od, oi) in zip(got, want, one):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gi, oi)
        np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(gd, od)
    rep = sharded.storage_report()
    assert rep["num_devices"] == 8 and rep["graph_mb_total"] > 0
    assert not sharded.packed   # a lossy arena scores the arena's rows


def test_dynamic_mesh_graph_serving(small_world, small_corpus, mine, arenas,
                                    one_thread):
    """build_dynamic_searcher(mesh=...) on the reference's plan: the
    graph partitions placed over 8 devices, the same result sets as the
    port's one-device batcher and as the reference's mesh searcher."""
    ra, pa = arenas
    world, corpus = mine
    cfgs = []
    for cfg in (RefFrameworkConfig(), FrameworkConfig()):
        cfg.index.kind = "hnsw"
        cfg.index.hnsw_m = 8
        cfg.index.hnsw_ef_construction = 48
        cfg.search.ef_search = 32
        cfg.optimizer.storage_alpha = 1.5
        cfgs.append(cfg)
    ref = ref_dynamic(small_corpus, small_world, ra, cfgs[0], packed=False,
                      mesh=ref_make_mesh(8, n_replicas=1))
    plan = plan_from_reference(ref.plan)
    one = build_dynamic_searcher(corpus, world, pa, cfgs[1], plan=plan,
                                 packed=False)
    s = build_dynamic_searcher(corpus, world, pa, cfgs[1], plan=plan,
                               packed=False, mesh=make_mesh(8, devices=CPU8))
    assert isinstance(s.graph_batcher, ShardedGraphSearcher)
    assert isinstance(one.graph_batcher, GraphProbeBatcher)
    assert s.graph_batcher.n_devices == 8
    q, users = _draw(corpus, world, 9, 32)
    got = s.search_batch(q, users, world.user_masks, 8)
    want_one = one.search_batch(q, users, world.user_masks, 8)
    want_ref = ref.search_batch(q, users, small_world.user_masks, 8)
    for qi in range(len(q)):
        g = set(int(x) for x in got[1][qi] if x >= 0)
        assert g == set(int(x) for x in want_one[1][qi] if x >= 0), qi
        assert g == set(int(x) for x in want_ref[1][qi] if x >= 0), qi


# ---- the serving front end over a sharded searcher


def test_serving_over_sharded_searcher(mine, one_thread):
    """The BatchingServer over ShardedGlobalSearcher (4 shards x 2
    replicas): every request's ids equal the direct search_batch's, and
    requests coalesce into batches."""
    world, corpus = mine
    s = ShardedGlobalSearcher(corpus, world,
                              mesh=make_mesh(8, n_replicas=2, devices=CPU8),
                              block_rows=64)
    q, uids = _draw(corpus, world, 4, 24)
    _, want_i = s.search_batch(q, uids, world.user_masks, k=6)
    with BatchingServer(s, world.user_masks, max_batch=8,
                        max_wait_ms=10.0) as srv:
        tickets = [srv.submit(q[j], uids[j], 6) for j in range(len(q))]
        for j, t in enumerate(tickets):
            np.testing.assert_array_equal(t.result(timeout=120).row_ids,
                                          want_i[j])
        stats = srv.stats()
    assert stats["served"] == len(q) and stats["avg_batch"] > 1.0
