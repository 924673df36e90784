"""The port's QDTree strategy against the JAX reference on the CPU.

Both packages build the same small world at the reference's
tests/test_qdtree.py size (24 roles, 200 documents of 4 rows, 120 users),
each with its own code, on a SIFT-like corpus of 32 dimensions (integer
valued, so the int8 arena is lossless and every distance exact); the
port's arena comes from the reference's through arena_from_reference. The
tree builders share a seed and take the same numpy steps, so trees,
routes and ids must be equal. Ids are compared per query with
equal-distance ids as sets (the chunk engines order ties differently)."""

import numpy as np
import pytest

import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu.bench.queries import (
    generate_query_workload as ref_workload)
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.partition import qdtree as ref_qdtree
from vectorsearch_rbac_tpu.partition import qdtree_debug as ref_debug
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch.partition import qdtree, qdtree_debug

WORLD = dict(num_users=120, num_roles=24, num_docs=200, h=3, b0=2, b1=3,
             seed=7)
CORPUS = dict(num_vectors=800, dim=32, blocks_per_doc=4, seed=3)
K = 8


def _cfgs():
    out = []
    for cfg in (RefFrameworkConfig(), port.FrameworkConfig()):
        cfg.index.kind = "flat_approx"
        cfg.search.block_rows = 128
        cfg.search.batch_size = 16
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def qd():
    """Both packages' worlds, corpora and arenas, the reference's
    workload, and each package's QDTree searcher built from it."""
    rw = RefTreeGenerator(**WORLD).generate()
    rc, _ = ref_corpus(**CORPUS)
    ra = ref_arena(rc, rw, block_rows=128, dtype="int8")
    pw = port.TreeRBACGenerator(**WORLD).generate()
    pc, _ = port.sift_like_corpus(**CORPUS)
    pa = arena_from_reference(ra, "cpu")
    wl = ref_workload(rc, rw, num_queries=20, topk=5, seed=8)
    rcfg, pcfg = _cfgs()
    kw = dict(workload=wl, min_leaf=16, max_depth=6)
    return dict(rw=rw, rc=rc, ra=ra, pw=pw, pc=pc, pa=pa, wl=wl, rcfg=rcfg,
                pcfg=pcfg,
                ref=ref_searcher("qdtree", rc, rw, ra, rcfg, **kw),
                mine=build_searcher("qdtree", pc, pw, pa, pcfg, **kw))


def _queries(qd, n, seed):
    """Corpus rows with integer noise (routes fall on both sides of the
    centroid predicates; integer queries keep the int8 scan exact) and
    random users."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, qd["pc"].n, n)
    noise = np.round(rng.normal(0, 8, (n, qd["pc"].dim)))
    q = np.clip(qd["pc"].vectors[rows] + noise, 0, 255).astype(np.float32)
    return q, rng.integers(0, qd["pw"].num_users, n)


def _assert_same_trees(got, want):
    assert len(got.leaf_rows) == len(want.leaf_rows)
    for g, w in zip(got.leaf_rows, want.leaf_rows):
        np.testing.assert_array_equal(g, w)
    assert got.leaf_docs == want.leaf_docs
    assert got.route_radius == want.route_radius

    def walk(g, w):
        assert g.leaf_id == w.leaf_id
        if g.leaf_id >= 0:
            assert g.docs == w.docs
            return
        assert g.pred[0] == w.pred[0]
        if g.pred[0] == "role":
            assert g.pred[1] == w.pred[1]
        else:
            for a, b in zip(g.pred[1:], w.pred[1:]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        walk(g.left, w.left)
        walk(g.right, w.right)

    walk(got.root, want.root)


def _assert_same_results(got, want):
    """Per query: equal distance lists, and at every distance the same ids
    (as sets)."""
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gd, np.float64),
                                  np.asarray(wd, np.float64))
    for q in range(len(gi)):
        for v in np.unique(wd[q]):
            assert set(gi[q][gd[q] == v]) == set(wi[q][wd[q] == v]), (q, v)


@pytest.mark.parametrize("sample", ["workload", "combs"])
def test_tree_equals_reference(qd, sample):
    """build_qd_tree on the same inputs and seed: the same leaf rows and
    documents, the same predicates (role ids; centroids to 1e-6) and the
    same route radius, with the workload's vectors (the radius rule) and
    with the first role combinations only (the bench's build: no vectors,
    the margin rule)."""
    if sample == "workload":
        _assert_same_trees(qd["mine"].tree, qd["ref"].tree)
        assert qd["mine"].tree.route_radius is not None
        assert len(qd["mine"].tree.leaf_rows) > 1
        return
    want = ref_qdtree.build_qd_tree(
        qd["rc"], qd["rw"], [qd["rw"].comb_docs(c) for c in qd["rw"].combs[:64]],
        min_leaf=16, max_depth=6, seed=0)
    got = qdtree.build_qd_tree(
        qd["pc"], qd["pw"], [qd["pw"].comb_docs(c) for c in qd["pw"].combs[:64]],
        min_leaf=16, max_depth=6, seed=0)
    _assert_same_trees(got, want)
    assert got.route_radius is None and len(got.leaf_rows) > 1


def test_batch_router_matches_route_and_reference(qd):
    """The vectorized batch router makes route()'s decisions (through the
    CSR doc -> leaf map) and the reference's batch router's, on 40 random
    queries; the CSR map holds each document's leaves."""
    q, users = _queries(qd, 40, 11)
    mine = qd["mine"]
    got = mine.batch_router(q, users)
    want = qd["ref"].batch_router(q, users)
    for qi in range(40):
        assert set(got[qi]) == set(mine.vector_router(int(users[qi]), q[qi]))
        assert tuple(got[qi]) == tuple(want[qi]), qi
    assert len({len(g) for g in got}) > 1        # routes differ
    tree = mine.tree
    leaf_ids = [i for i, r in enumerate(tree.leaf_rows) if len(r)]
    ptr, cols = qdtree.leaf_doc_csr(tree, leaf_ids, qd["pc"].num_docs)
    assert len(cols) == sum(len(tree.leaf_docs[lid]) for lid in leaf_ids)
    for d in range(qd["pc"].num_docs):
        want_cols = [c for c, lid in enumerate(leaf_ids)
                     if d in tree.leaf_docs[lid]]
        assert sorted(cols[ptr[d]:ptr[d + 1]]) == want_cols


@pytest.mark.parametrize("packed", [True, False],
                         ids=["tiled", "flat_approx-leaves"])
def test_search_matches_reference(qd, packed):
    """search_batch through the TiledSearcher (packed) and through one
    Int8FlatIndex a leaf (packed=False, flat_approx): the reference's ids
    and distances, on the workload's queries and on 40 random ones."""
    kw = dict(tree=qd["ref"].tree, packed=packed)
    ref = ref_searcher("qdtree", qd["rc"], qd["rw"], qd["ra"], qd["rcfg"],
                       **kw)
    mine = build_searcher("qdtree", qd["pc"], qd["pw"], qd["pa"],
                          qd["pcfg"], tree=qd["mine"].tree, packed=packed)
    assert type(mine).__name__ == ("TiledSearcher" if packed
                                   else "PartitionedSearcher")
    q, users = _queries(qd, 40, 12)
    for qv, uid in ((qd["wl"].vectors, qd["wl"].user_ids), (q, users)):
        want = ref.search_batch(qv, uid, qd["rw"].user_masks, K)
        got = mine.search_batch(qv, uid, qd["pw"].user_masks, K)
        _assert_same_results(got, want)
        assert (got[1] >= 0).sum() > 0.5 * got[1].size


def test_exact_without_pruning(qd):
    """With centroid pruning off a query visits every leaf its user can
    read, and the leaves' exact scans give the exact masked kNN: the same
    distance lists as the brute-force oracle, ids equal below the k-th
    distance."""
    s = build_searcher("qdtree", qd["pc"], qd["pw"], qd["pa"], qd["pcfg"],
                       tree=qd["mine"].tree, prune_by_centroid=False)
    q, users = _queries(qd, 40, 13)
    d, ids = s.search_batch(q, users, qd["pw"].user_masks, K)
    pc, pw = qd["pc"], qd["pw"]
    for qi in range(len(q)):
        docs = pw.user_docs(int(users[qi]))
        rows = pc.rows_for_docs(np.fromiter(docs, dtype=np.int64,
                                            count=len(docs)))
        dd = ((pc.vectors[rows].astype(np.float64) - q[qi]) ** 2).sum(1)
        order = np.argsort(dd, kind="stable")[:K]
        got = ids[qi][ids[qi] >= 0]
        gd = ((pc.vectors[got].astype(np.float64) - q[qi]) ** 2).sum(1)
        np.testing.assert_allclose(np.sort(gd), dd[order], rtol=1e-9)
        kth = dd[order].max()
        assert set(rows[order][dd[order] < kth]) == set(got[gd < kth]), qi


def test_save_load_round_trip(qd, tmp_path):
    """A saved tree loads as the port's own classes and serves as the
    original does (the port cannot load the reference's pickles, whose
    classes are the reference's)."""
    path = str(tmp_path / "tree.pkl")
    qd["mine"].tree.save(path)
    tree = qdtree.QDTree.load(path)
    assert type(tree) is qdtree.QDTree and type(tree.root) is qdtree.QDNode
    _assert_same_trees(tree, qd["mine"].tree)
    s2 = build_searcher("qdtree", qd["pc"], qd["pw"], qd["pa"], qd["pcfg"],
                        tree=tree)
    q, users = _queries(qd, 20, 14)
    assert s2.batch_router(q, users) == qd["mine"].batch_router(q, users)
    _assert_same_results(
        s2.search_batch(q, users, qd["pw"].user_masks, K),
        qd["mine"].search_batch(q, users, qd["pw"].user_masks, K))


def test_debug_helpers_print_the_reference_strings(qd):
    """export_dot, dump_structure, trace_query and list_role_partitions on
    equal trees give the reference's strings and records."""
    mine, ref = qd["mine"].tree, qd["ref"].tree
    assert qdtree_debug.export_dot(mine) == ref_debug.export_dot(ref)
    assert qdtree_debug.dump_structure(mine) == ref_debug.dump_structure(ref)
    q, users = _queries(qd, 4, 15)
    for qv, uid in zip(q, users):
        assert (qdtree_debug.trace_query(mine, qd["pw"], int(uid), qv)
                == ref_debug.trace_query(ref, qd["rw"], int(uid), qv))
    assert (qdtree_debug.list_role_partitions(mine, qd["pw"])
            == ref_debug.list_role_partitions(ref, qd["rw"]))
    assert qdtree_debug.export_dot(mine).count("leaf") >= len(mine.leaf_docs)


def test_validate_catches_a_dropped_row(qd):
    """A tree whose highest row is dropped from its leaf: the port's check
    raises (the leaves' rows no longer total the corpus's), where the
    reference's check passes it; a row in two leaves raises too."""
    n = qd["pc"].n
    for tree, mod, world in ((qd["mine"].tree, qdtree, qd["pw"]),
                             (qd["ref"].tree, ref_qdtree, qd["rw"])):
        dropped = mod.QDTree(root=tree.root, leaf_docs=tree.leaf_docs,
                             leaf_rows=[r[r != n - 1] for r in tree.leaf_rows],
                             route_radius=tree.route_radius)
        if mod is qdtree:
            qdtree.validate_qdtree_partitions(tree, world, n)
            with pytest.raises(ValueError, match="do not partition"):
                qdtree.validate_qdtree_partitions(dropped, world, n)
            twice = qdtree.QDTree(
                root=tree.root, leaf_docs=tree.leaf_docs,
                leaf_rows=[np.concatenate([tree.leaf_rows[0],
                                           tree.leaf_rows[1][:1]]),
                           *tree.leaf_rows[1:]],
                route_radius=tree.route_radius)
            with pytest.raises(ValueError, match="do not partition"):
                qdtree.validate_qdtree_partitions(twice, world, n)
        else:
            ref_qdtree.validate_qdtree_partitions(dropped, world)


def test_non_l2_arena_is_refused_before_any_tree(qd, monkeypatch):
    """A cosine arena, once refused (queue 1 item 8), now serves through
    the PackedSearcher: the tree is built on unit vectors, so its route
    radius and leaves equal the reference's built from the unit corpus and
    unit workload vectors, and its ids equal that reference searcher's
    (its packed scan given the cosine metric, the reference defect the
    port fixes), every row readable."""
    import dataclasses

    import jax

    from vectorsearch_rbac_tpu.core import Corpus as RefCorpus
    from vectorsearch_rbac_tpu.ops.ivf_scan import probed_topk as ref_probed
    from vectorsearch_rbac_tpu.partition import packed as ref_packed
    from vectorsearch_rbac_tpu_torch.partition.packed import PackedSearcher

    fn = jax.jit(lambda q, s, v, n, b, r, m, k, mode: ref_probed(
        q, s, v, n, b, r, m, k, mode=mode, metric="cosine"),
        static_argnums=(7, 8))
    monkeypatch.setattr(
        ref_packed, "_packed_search_fn",
        lambda q, s, v, n, b, r, m, k, mode="approx": fn(q, s, v, n, b, r, m,
                                                         k, mode))
    ra = ref_arena(qd["rc"], qd["rw"], block_rows=128, dtype="int8",
                   metric="cosine")
    unit = qdtree.unit_rows
    rc = RefCorpus(vectors=unit(qd["rc"].vectors), doc_ids=qd["rc"].doc_ids,
                   block_ids=qd["rc"].block_ids)
    wl = dataclasses.replace(qd["wl"], vectors=unit(qd["wl"].vectors))
    kw = dict(min_leaf=16, max_depth=6)
    want_s = ref_searcher("qdtree", rc, qd["rw"], ra, qd["rcfg"],
                          workload=wl, **kw)
    got_s = build_searcher("qdtree", qd["pc"], qd["pw"],
                           arena_from_reference(ra, "cpu"), qd["pcfg"],
                           workload=qd["wl"], **kw)
    assert isinstance(got_s, PackedSearcher)
    assert want_s.tree.route_radius is not None
    assert got_s.tree.route_radius == pytest.approx(
        want_s.tree.route_radius, rel=1e-6)
    for g, w in zip(got_s.tree.leaf_rows, want_s.tree.leaf_rows):
        np.testing.assert_array_equal(g, w)
    q, users = _queries(qd, 30, seed=12)
    got = got_s.search_batch(q, users, qd["pw"].user_masks, K)
    want = want_s.search_batch(unit(q), users, qd["rw"].user_masks, K)
    np.testing.assert_array_equal(got[1] < 0, want[1] < 0)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for qi in range(len(q)):
        assert set(got[1][qi]) == set(want[1][qi]), qi
    bits = qd["pc"].vector_role_bits(qd["pw"])
    for qi, u in enumerate(users):
        for r in got[1][qi][got[1][qi] >= 0]:
            assert (bits[r] & qd["pw"].user_masks[u]).any()