"""The port's PackedSearcher (ROLE, USER, AnonySys and QDTree on every arena
the TiledSearcher does not take) against the JAX reference on the CPU.

Both packages build the world and a SIFT-like corpus (1,200 rows of 32
dimensions) from the same seeds with their own code; the port's arena
comes from the reference's through arena_from_reference. Three arenas: an
int8 cosine arena and an int8 ip arena (bfloat16 mirrors: the packed
lists are bfloat16) and a float32 l2 arena.

The reference's PackedSearcher runs the probed scan without the arena's
metric (its `_packed_search_fn` takes squared L2 whatever the arena), a
defect the port fixes; the reference runs here with that one call given
the metric, so that both compute the same function. On a cosine arena
the port's QDTree is built and routes on unit vectors, which the
reference does when it is handed the unit corpus and unit queries.

Distances are compared to rtol 1e-5 of the largest finite distance of
the case; ids equal except among distances within that tolerance, which
compare as sets (the ROADMAP tie rule)."""

import jax
import numpy as np
import pytest
import torch

import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu.bench.queries import (
    generate_query_workload as ref_workload)
from vectorsearch_rbac_tpu.core import Corpus as RefCorpus
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.ops.ivf_scan import probed_topk as ref_probed
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.partition import packed as ref_packed
from vectorsearch_rbac_tpu.partition import qdtree as ref_qdtree
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch.partition import qdtree
from vectorsearch_rbac_tpu_torch.partition.packed import (
    PackedSearcher, _bucket_len)
from vectorsearch_rbac_tpu_torch.partition.qdtree import unit_rows

WORLD = dict(num_users=80, num_roles=16, num_docs=120, h=3, b0=2, b1=2,
             seed=5)
CORPUS = dict(num_vectors=1200, dim=32, blocks_per_doc=10, seed=4)
NQ, K = 40, 8
# the bench flags' searchers: the fewest rows (100 documents of 100 blocks)
# the bench's 100-role world accepts
N_BENCH = 10_000
RTOL = 1e-5
ARENAS = [("int8", "cosine"), ("int8", "ip"), ("float32", "l2")]


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
        if ok.any():
            last = wd[q][ok].max()
            assert (set(gi[q][np.isfinite(gd[q]) & (gd[q] < last - tol)])
                    == set(wi[q][ok & (wd[q] < last - tol)])), q


def assert_readable(corpus, world, ids, users):
    bits = corpus.vector_role_bits(world)
    for q, u in enumerate(users):
        for r in ids[q][ids[q] >= 0]:
            assert (bits[r] & world.user_masks[u]).any(), (q, r)


def ref_in_metric(monkeypatch, metric: str) -> None:
    """The reference's packed scan, given the arena's metric."""
    fn = jax.jit(lambda q, s, v, n, b, r, m, k, mode: ref_probed(
        q, s, v, n, b, r, m, k, mode=mode, metric=metric),
        static_argnums=(7, 8))
    monkeypatch.setattr(
        ref_packed, "_packed_search_fn",
        lambda q, s, v, n, b, r, m, k, mode="approx": fn(q, s, v, n, b, r, m,
                                                         k, mode))


def unit_corpus(c):
    return RefCorpus(vectors=unit_rows(c.vectors), doc_ids=c.doc_ids,
                     block_ids=c.block_ids)


@pytest.fixture(scope="module")
def worlds():
    rw = RefTreeGenerator(**WORLD).generate()
    rc, _ = ref_corpus(**CORPUS)
    pw = port.TreeRBACGenerator(**WORLD).generate()
    pc, _ = port.sift_like_corpus(**CORPUS)
    rng = np.random.default_rng(9)
    rows = rng.integers(0, rc.n, NQ)
    q = (rc.vectors[rows] + rng.normal(0, 12, (NQ, rc.dim))).astype(
        np.float32)
    users = rng.integers(0, rw.num_users, NQ)
    return dict(rw=rw, rc=rc, pw=pw, pc=pc, q=q, users=users, arenas={
        kind: ref_arena(rc, rw, block_rows=256, dtype=kind[0],
                        metric=kind[1]) for kind in ARENAS})


def _cfgs(kind="flat_approx"):
    out = []
    for cfg in (RefFrameworkConfig(), port.FrameworkConfig()):
        cfg.index.kind = kind
        cfg.search.batch_size = 16
        out.append(cfg)
    return out


@pytest.mark.parametrize("arena", ARENAS, ids=lambda a: "-".join(a))
@pytest.mark.parametrize("name", ["role", "user", "dynamic", "qdtree"])
def test_packed_strategy_matches_reference(worlds, monkeypatch, arena, name):
    """ROLE, USER, AnonySys (the port's own planner) and QDTree (built as
    the bench builds it, from the first 64 role combinations) through
    build_searcher: the same buckets, storage and ids as the reference's
    PackedSearcher, every row readable by its user."""
    w = worlds
    ra = w["arenas"][arena]
    ref_in_metric(monkeypatch, arena[1])
    rcfg, pcfg = _cfgs()
    cosine_tree = name == "qdtree" and arena[1] == "cosine"
    rc = unit_corpus(w["rc"]) if cosine_tree else w["rc"]
    want_s = ref_searcher(name, rc, w["rw"], ra, rcfg)
    got_s = build_searcher(name, w["pc"], w["pw"],
                           arena_from_reference(ra, "cpu"), pcfg)
    assert isinstance(got_s, PackedSearcher) and got_s.mode == want_s.mode
    assert got_s.bucket_shapes == [(b.p, b.l_pad) for b in want_s.buckets]
    assert got_s.bucket_of_pid == want_s.bucket_of_pid
    assert got_s.storage_report() == pytest.approx(want_s.storage_report())
    qr = unit_rows(w["q"]) if cosine_tree else w["q"]
    want = want_s.search_batch(qr, w["users"], w["rw"].user_masks, K)
    got = got_s.search_batch(w["q"], w["users"], w["pw"].user_masks, K)
    assert_same_topk(got, want)
    assert (got[1] >= 0).sum() > 0.5 * got[1].size
    assert_readable(w["pc"], w["pw"], got[1], w["users"])


def test_packed_exact_mode_and_buckets(worlds, monkeypatch):
    """Index kind flat gives mode exact, as the reference's; partitions of
    one power-of-two size class share a bucket, and a pass with a user of
    no partition returns -1 / inf rows."""
    w = worlds
    ra = w["arenas"][("float32", "l2")]
    ref_in_metric(monkeypatch, "l2")
    rcfg, pcfg = _cfgs("flat")
    want_s = ref_searcher("role", w["rc"], w["rw"], ra, rcfg)
    got_s = build_searcher("role", w["pc"], w["pw"],
                           arena_from_reference(ra, "cpu"), pcfg)
    assert got_s.mode == want_s.mode == "exact"
    for n in (1, 1024, 1025, 5000):
        assert _bucket_len(n) == ref_packed._bucket_len(n)
    masks = w["pw"].user_masks.copy()
    masks[w["users"][0]] = 0
    got = got_s.search_batch(w["q"], w["users"], masks, K)
    want = want_s.search_batch(w["q"], w["users"], masks, K)
    assert_same_topk(got, want)


def test_qdtree_route_radius_by_metric(worlds):
    """The route radius in the arena's metric: on cosine the reference's
    estimate over the unit corpus and unit query vectors (and the same
    tree); on ip none (the margin rule routes); on l2 the reference's."""
    w = worlds
    wl = ref_workload(w["rc"], w["rw"], num_queries=30, topk=5, seed=8)
    docsets = [w["rw"].user_docs(int(u)) for u in wl.user_ids]
    kw = dict(min_leaf=16, max_depth=6, seed=0)
    for metric in ("l2", "cosine", "ip"):
        got = qdtree.build_qd_tree(w["pc"], w["pw"], docsets,
                                   query_vecs=wl.vectors, metric=metric, **kw)
        unit = metric == "cosine"
        want = ref_qdtree.build_qd_tree(
            unit_corpus(w["rc"]) if unit else w["rc"], w["rw"], docsets,
            query_vecs=unit_rows(wl.vectors) if unit else wl.vectors, **kw)
        assert want.route_radius is not None
        if metric == "ip":
            assert got.route_radius is None
            continue
        assert got.route_radius == pytest.approx(want.route_radius,
                                                 rel=1e-6)
        assert len(got.leaf_rows) == len(want.leaf_rows)
        for g, r in zip(got.leaf_rows, want.leaf_rows):
            np.testing.assert_array_equal(g, r)


def test_qdtree_workload_tree_on_ip_serves(worlds, monkeypatch):
    """QDTree from a sampled workload on the ip arena: no radius, and the
    reference fed the port's tree (as its own QDTree) returns the same
    ids."""
    w = worlds
    ra = w["arenas"][("int8", "ip")]
    ref_in_metric(monkeypatch, "ip")
    wl = ref_workload(w["rc"], w["rw"], num_queries=30, topk=5, seed=8)
    rcfg, pcfg = _cfgs()
    kw = dict(min_leaf=16, max_depth=6)
    got_s = build_searcher("qdtree", w["pc"], w["pw"],
                           arena_from_reference(ra, "cpu"), pcfg,
                           workload=wl, **kw)
    tree = got_s.tree
    assert tree.route_radius is None

    def to_ref(node):
        return ref_qdtree.QDNode(
            pred=node.pred, leaf_id=node.leaf_id, docs=node.docs,
            left=None if node.left is None else to_ref(node.left),
            right=None if node.right is None else to_ref(node.right))

    ref_tree = ref_qdtree.QDTree(root=to_ref(tree.root),
                                 leaf_docs=tree.leaf_docs,
                                 leaf_rows=tree.leaf_rows, route_radius=None)
    want_s = ref_searcher("qdtree", w["rc"], w["rw"], ra, rcfg,
                          tree=ref_tree, **kw)
    got = got_s.search_batch(w["q"], w["users"], w["pw"].user_masks, K)
    want = want_s.search_batch(w["q"], w["users"], w["rw"].user_masks, K)
    assert_same_topk(got, want)
    assert_readable(w["pc"], w["pw"], got[1], w["users"])


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test: the bench's searchers
    (IVF lists a role partition, the planner) run many small ops, which
    stall on a contended intra-op pool when other test workers share the
    cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("flags", [
    ["--strategy", "role", "--dataset", "cohere", "--metric", "cosine"],
    ["--strategy", "user", "--metric", "ip"],
    ["--strategy", "dynamic", "--dtype", "float32"],
    ["--strategy", "qdtree", "--metric", "cosine", "--index", "flat"],
    ["--index", "ivf"],
    ["--strategy", "role", "--index", "ivf", "--dtype", "float32"],
    ["--strategy", "dynamic", "--index", "hnsw"],
    ["--index", "flat", "--dtype", "float32"],
    ["--strategy", "rls", "--dtype", "float32"],
    ["--dtype", "bfloat16"],
    ["--metric", "l1", "--dtype", "float32"],
    ["--dataset", "synthetic", "--dtype", "float32", "--metric", "l1",
     "--index", "flat"],
    ["--index", "binary", "--dtype", "float32"],
    ["--index", "hnsw"],
    ["--strategy", "qdtree", "--index", "hnsw"],
    ["--strategy", "dynamic", "--index", "hnsw", "--metric", "cosine"],
    ["--strategy", "role", "--index", "hnsw", "--metric", "ip"],
    ["--strategy", "user", "--index", "hnsw", "--dtype", "float32",
     "--metric", "l1"],
])
def test_bench_serves_the_packed_and_ivf_flags(flags, one_thread):
    """The bench parses the flags, and the searcher it builds for them at
    N_BENCH rows on the CPU answers 8 queries with readable rows (HNSW
    under every strategy and metric included)."""
    from vectorsearch_rbac_tpu_torch.bench import make_scenario, serving_config
    from vectorsearch_rbac_tpu_torch.bench.__main__ import parse_args

    args = parse_args(flags)
    for f, v in zip(flags[::2], flags[1::2]):
        assert getattr(args, f[2:]) == v
    corpus, world, wl = make_scenario(n=N_BENCH, num_queries=8, topk=K,
                                      dataset=args.dataset)
    cfg = serving_config(block_rows=1024, topk=K, index=args.index,
                         dtype=args.dtype, strategy=args.strategy)
    # narrow graphs: the flags' serving is under test, not the graphs' width
    cfg.index.hnsw_m, cfg.index.hnsw_ef_construction = 8, 32
    arena = port.build_device_arena(corpus, world, device="cpu",
                                    block_rows=1024, dtype=args.dtype,
                                    metric=args.metric)
    searcher = build_searcher(args.strategy, corpus, world, arena, cfg)
    _, ids = searcher.search_batch(wl.vectors, wl.user_ids,
                                   world.user_masks, K)
    assert ids.shape == (8, K) and (ids >= 0).sum() > ids.size // 2
    assert_readable(corpus, world, ids, wl.user_ids)


@pytest.mark.parametrize("flags,why", [
    # ROADMAP queue 1 item 14 (the 10M cell) is ported: its flags parse
    pytest.param(["--dataset", "sift10m", "--n", "10000000"], None,
                 id="flags0-ROADMAP queue 1 item 14"),
    (["--metric", "l1"], "l1 cannot ride the int8 path"),
])
def test_bench_refusals_name_their_item(flags, why, capsys):
    """The bench takes every ROADMAP item's flags (--dataset sift10m at
    --n 10000000, rls on the int8 arena), and refuses only what the
    reference refuses, with its reason (l1 on the int8 arena)."""
    from vectorsearch_rbac_tpu_torch.bench.__main__ import (parse_args,
                                                            refusal)

    if why is None:
        args = parse_args(flags)
        assert (args.dataset, args.n, args.strategy, args.dtype) == (
            "sift10m", 10_000_000, "rls", "int8")
        assert refusal(args) is None
        assert parse_args(["--dataset", "sift10m", "--strategy", "dynamic",
                           "--topk", "10", "--queries", "8192"]).topk == 10
        return
    with pytest.raises(SystemExit):
        parse_args(flags)
    assert why in capsys.readouterr().err
