"""Row deletes in the port against the JAX reference on the CPU: arena
tombstones (core.tombstone_rows) under every engine, HNSW graph repair
(HNSWIndex.delete_rows, which also rebinds the index to the tombstoned
arena), compaction (core.compact_corpus) and the rows a role delete
orphans, on the reference's tests/test_delete.py world and corpus.

The lifecycle is pgvector's delete before vacuum: phase 1 zeroes the
rows' role bits (every permission test rejects them), phase 2 repairs the
graph so the nodes are unreachable, phase 3 rebuilds without them."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.core import compact_corpus as ref_compact
from vectorsearch_rbac_tpu.core import tombstone_rows as ref_tombstone
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.index.hnsw import HNSWIndex as RefHNSWIndex
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.core import (build_device_arena,
                                              compact_corpus, tombstone_rows)
from vectorsearch_rbac_tpu_torch.index.flat import FlatIndex
from vectorsearch_rbac_tpu_torch.index.flat_int8 import Int8FlatIndex
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.index.ivf import IVFIndex
from vectorsearch_rbac_tpu_torch.partition.dynamic import (
    orphaned_docs_after_role_delete, orphaned_rows_after_role_delete)
from vectorsearch_rbac_tpu_torch.rbac import RBACWorld, pack_role_sets
from test_torch_ivf import assert_same_topk


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU ops on one thread (the graph searches run many small
    ops, which stall on a contended intra-op pool)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world():
    return RefTreeGenerator(num_users=80, num_roles=16, num_docs=120, h=3,
                            b0=2, b1=2, seed=5).generate()


@pytest.fixture(scope="module")
def corpus():
    return ref_corpus(num_vectors=1200, dim=32, blocks_per_doc=10, seed=4)[0]


@pytest.fixture(scope="module")
def arenas(corpus, world):
    """The reference's int8 arena and the port's copy."""
    ra = ref_arena(corpus, world, block_rows=256, dtype="int8")
    return ra, arena_from_reference(ra, "cpu")


def _workload(corpus, world, nq, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, (nq, corpus.dim)).astype(np.float32)
    users = rng.integers(0, world.num_users, nq)
    return q, users, world.user_masks[users]


def _oracle_ids(corpus, world, q, mask, k, excluded):
    bits = corpus.vector_role_bits(world)
    adm = (bits & mask).any(axis=1)
    adm[list(excluded)] = False
    dist = ((corpus.vectors.astype(np.float64) - q) ** 2).sum(axis=1)
    dist[~adm] = np.inf
    return [int(i) for i in np.argsort(dist, kind="stable")[:k]
            if np.isfinite(dist[i])]


def _port_world(w) -> RBACWorld:
    return RBACWorld(num_users=w.num_users, num_roles=w.num_roles,
                     num_docs=w.num_docs, user_to_roles=dict(w.user_to_roles),
                     role_to_docs=dict(w.role_to_docs))


def test_tombstone_rows_matches_reference(arenas, corpus):
    """The new arena's bits (device and host) are the reference's; it
    shares every other buffer with the old arena, which keeps its bits."""
    ra, pa = arenas
    deleted = np.sort(np.random.default_rng(11).choice(corpus.n, 120,
                                                       replace=False))
    want = ref_tombstone(ra, deleted)
    got = tombstone_rows(pa, deleted)
    np.testing.assert_array_equal(got.host_bits, want.host_bits)
    np.testing.assert_array_equal(got.role_bits.numpy().view(np.uint32),
                                  np.asarray(want.role_bits))
    assert not got.host_bits[deleted].any()
    assert pa.host_bits[deleted].any() and pa.role_bits[deleted].any()
    assert got.vectors is pa.vectors and got.norms is pa.norms
    assert got.quant is pa.quant and got.host_vectors is pa.host_vectors


@pytest.mark.parametrize("engine", ["int8", "flat", "ivf"])
def test_tombstoned_rows_never_return(arenas, corpus, world, engine):
    """Int8FlatIndex, FlatIndex and IVFIndex built on the tombstoned arena
    return no tombstoned row; the exact engine returns the oracle's rows
    over the remaining rows, and the reference's results."""
    ra, pa = arenas
    deleted = np.sort(np.random.default_rng(11).choice(
        corpus.n, corpus.n // 10, replace=False))
    arena2 = tombstone_rows(pa, deleted)
    q, _, masks = _workload(corpus, world, 16)
    k = 8
    ix = {"int8": lambda: Int8FlatIndex(arena2, None, query_batch=32,
                                        block_rows=256, group=8),
          "flat": lambda: FlatIndex(arena2, block_rows=256, mode="exact",
                                    query_batch=32),
          "ivf": lambda: IVFIndex(arena2, None, nlist=8, nprobe=8,
                                  query_batch=32, seed=1)}[engine]()
    d, ids = ix.search(q, masks, k)
    assert not np.isin(ids, deleted).any()
    assert (ids >= 0).mean() > 0.5
    if engine == "flat":
        dset = set(deleted.tolist())
        for qi in range(16):
            want = _oracle_ids(corpus, world, q[qi], masks[qi], k, dset)
            assert set(int(x) for x in ids[qi] if x >= 0) == set(want)
        from vectorsearch_rbac_tpu.index.flat import FlatIndex as RefFlat
        ref = RefFlat(ref_tombstone(ra, deleted), rows=None, block_rows=256,
                      mode="exact", query_batch=32)
        assert_same_topk((d, ids), ref.search(q, masks, k))


def test_compact_corpus_matches_reference(corpus, world):
    """compact_corpus gives the reference's corpus and remap; the arena
    rebuilt from it is smaller."""
    deleted = np.sort(np.random.default_rng(3).choice(corpus.n,
                                                      corpus.n // 5,
                                                      replace=False))
    got, remap = compact_corpus(corpus, deleted)
    want, want_remap = ref_compact(corpus, deleted)
    np.testing.assert_array_equal(remap, want_remap)
    for field in ("vectors", "doc_ids", "block_ids"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (remap[deleted] == -1).all() and got.n == corpus.n - len(deleted)
    keep = np.setdiff1d(np.arange(corpus.n), deleted)
    np.testing.assert_array_equal(remap[keep], np.arange(len(keep)))
    pworld = _port_world(world)
    a1 = build_device_arena(corpus, pworld, device="cpu", block_rows=256,
                            dtype="int8")
    a2 = build_device_arena(got, pworld, device="cpu", block_rows=256,
                            dtype="int8")
    assert a2.n < a1.n and a2.n_padded <= a1.n_padded


def test_hnsw_delete_rows_repair_matches_reference(arenas, corpus, world):
    """The reference's delete test: 10% of the rows tombstoned and deleted
    from an HNSW graph over all rows. The port's delete_rows rebinds the
    index to the tombstoned arena (the reference's test rebinds its bits by
    hand) and leaves the reference's graph, row map and entry; the
    sampled-entry search returns the reference's ids, no deleted row, and
    recall on the remaining rows >= 0.85."""
    ra, pa = arenas
    ref = RefHNSWIndex(ra, None, m=8, ef_construction=48, seed=3,
                       logical=True)
    mine = HNSWIndex(pa, None, m=8, graph_state=ref.graph_state())
    deleted = np.sort(np.random.default_rng(7).choice(corpus.n,
                                                      corpus.n // 10,
                                                      replace=False))
    ra2, pa2 = ref_tombstone(ra, deleted), tombstone_rows(pa, deleted)
    ref._bits = ra2.role_bits
    dl = np.flatnonzero(np.isin(mine._hrmap[:mine.n_rows], deleted))
    g0 = mine._hgraph
    pointing = int((np.isin(g0, dl).any(axis=1)
                    & ~np.isin(np.arange(len(g0)), dl)).sum())
    assert mine.delete_rows(pa2, deleted) == ref.delete_rows(ra2, deleted) \
        == len(deleted)
    assert mine.repaired_nodes == pointing > 0
    assert mine._arena is pa2 and mine._packed is None
    np.testing.assert_array_equal(mine._hgraph, np.asarray(ref._graph))
    np.testing.assert_array_equal(mine._row_map.numpy(),
                                  np.asarray(ref._row_map))
    np.testing.assert_array_equal(mine._deleted_local, ref._deleted_local)
    assert mine.entry == ref.entry
    q, _, masks = _workload(corpus, world, 20, seed=9)
    k = 6
    kw = dict(ef_search=48, iterative=True, sampled_entry=True)
    d, ids = mine.search(q, masks, k, **kw)
    assert_same_topk((d, ids), ref.search(q, masks, k, **kw))
    assert not np.isin(ids, deleted).any()
    dset = set(deleted.tolist())
    hits = total = 0
    for qi in range(20):
        want = _oracle_ids(corpus, world, q[qi], masks[qi], k, dset)
        hits += len(set(int(x) for x in ids[qi] if x >= 0) & set(want))
        total += max(len(want), 1)
    assert hits / total >= 0.85, f"post-delete recall {hits / total}"


def test_delete_rows_serves_the_new_bits_on_packed_rows(arenas, corpus,
                                                        world):
    """An index that built its packed rows (bitsets inside) before the
    delete serves the tombstone after it: delete_rows drops them, so rows
    tombstoned but still linked (deleted from the arena, not from this
    graph) never return either."""
    _, pa = arenas
    ix = HNSWIndex(pa, None, m=8, ef_construction=48, seed=3, logical=True)
    assert ix.use_packed
    q, _, masks = _workload(corpus, world, 16, seed=2)
    _, before = ix.search(q, masks, 6, sampled_entry=True)
    gone = np.unique(before[before >= 0])[:40]
    arena2 = tombstone_rows(pa, gone)
    assert ix.delete_rows(arena2, np.array([], np.int64)) == 0
    _, after = ix.search(q, masks, 6, sampled_entry=True)
    assert not np.isin(after, gone).any() and (after >= 0).any()


def test_delete_role_frees_orphaned_rows(corpus, world):
    """The documents only a role reads, and their rows, are the
    reference's; tombstoned, a user holding only that role reads none of
    them."""
    from vectorsearch_rbac_tpu.partition.dynamic.maintenance import (
        orphaned_docs_after_role_delete as ref_docs,
        orphaned_rows_after_role_delete as ref_rows)

    pworld = _port_world(world)
    role = next(r for r in range(world.num_roles)
                if orphaned_docs_after_role_delete(pworld, r))
    assert orphaned_docs_after_role_delete(pworld, role) == ref_docs(world,
                                                                     role)
    rows = orphaned_rows_after_role_delete(pworld, corpus.doc_ids, role)
    np.testing.assert_array_equal(rows, ref_rows(world, corpus.doc_ids,
                                                 role))
    assert len(rows) > 0
    arena = build_device_arena(corpus, pworld, device="cpu", block_rows=256,
                               dtype="float32")
    ix = FlatIndex(tombstone_rows(arena, rows), block_rows=256,
                   mode="exact", query_batch=32)
    q = corpus.vectors[rows[:4]].astype(np.float32)
    mask = np.repeat(pack_role_sets([(role,)], world.num_roles), 4, axis=0)
    _, ids = ix.search(q, mask, 5)
    assert not np.isin(ids, rows).any()
    _, ids = FlatIndex(arena, block_rows=256, mode="exact").search(q, mask, 5)
    assert np.isin(ids[:, 0], rows).all()      # before: their own rows


def test_refine_does_not_resurrect_deleted(arenas):
    """refine_rows over rows some of which are deleted never links them
    again, and a second delete of the same rows deletes none."""
    _, pa = arenas
    half = pa.n // 2
    ix = HNSWIndex(pa, np.arange(half), m=8, ef_search=64, query_batch=16,
                   builder="classic", seed=0)
    new_rows = np.arange(half, pa.n)
    ix.insert_rows(pa, new_rows)
    assert ix.n_rows == pa.n
    victims = new_rows[:20]
    assert ix.delete_rows(pa, victims) == 20
    assert ix.repaired_nodes > 0
    assert ix.delete_rows(pa, victims) == 0
    assert ix.repaired_nodes == 0
    ix.refine_rows(pa, new_rows)
    g, rmap = ix._graph.numpy(), ix._row_map.numpy()
    dead = np.flatnonzero(ix._deleted_local)
    assert len(dead) == 20 and (g[dead] < 0).all()
    assert (rmap[dead] == -1).all()
    live = np.ones(len(g), dtype=bool)
    live[dead] = False
    assert not np.isin(g[live], dead).any()
