"""HNSW's physical partitions (HNSWIndex logical=False, the reference's
default and cfg.index.hnsw_logical's) against the JAX reference on the
CPU, and the logical-vs-physical runner against the script it ports.

Both packages compute on the same state: the port's arena comes from the
reference's through arena_from_reference, the graphs from the same native
builder. The data is SIFT-like integer rows (3,000 of 32 dimensions, a
tree world of 16 roles) on four arenas: int8 l2 and int8 ip (lossless, so
the port's copy is the packed-row table, read through ops/graph_search.py
PackedCopy), float32 l2 and float32 l1 (the unpacked copy, the
reference's layout). The reference's copy is its bfloat16 or float32
rows; on these integer rows the two copies hold the same values, so ids
are held equal and distances within 1e-5 relative. The runner's case is
the script's protocol at 10,240 rows (the fewest its 100-role world
takes) and 64 queries."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.bench.ground_truth import (
    GroundTruthOracle as RefOracle)
from vectorsearch_rbac_tpu.bench.ground_truth import (
    compute_recall as ref_recall)
from vectorsearch_rbac_tpu.bench.queries import (
    QueryWorkload as RefWorkload)
from vectorsearch_rbac_tpu.bench.queries import (
    generate_query_workload as ref_workload)
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.index.flat_int8 import (
    Int8FlatIndex as RefInt8FlatIndex)
from vectorsearch_rbac_tpu.index.hnsw import HNSWIndex as RefHNSWIndex
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.partition.base import (
    BuiltPartition as RefBuiltPartition)
from vectorsearch_rbac_tpu.partition.base import (
    PartitionedSearcher as RefPartitionedSearcher)
from vectorsearch_rbac_tpu.partition.dynamic import (
    build_dynamic_searcher as ref_dynamic)
from vectorsearch_rbac_tpu.partition.graph_batch import (
    GraphProbeBatcher as RefGraphProbeBatcher)
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch.bench import logical_vs_physical as lvp
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.parallel.graph_sharded import (
    ShardedGraphSearcher)
from vectorsearch_rbac_tpu_torch.parallel.mesh import make_mesh
from vectorsearch_rbac_tpu_torch.partition.dynamic import plan_from_reference
from vectorsearch_rbac_tpu_torch.partition.graph_batch import (
    GraphProbeBatcher)
from test_torch_packed import assert_readable, assert_same_topk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = dict(num_users=80, num_roles=16, num_docs=60, h=3, b0=2, b1=2,
             seed=5)
CORPUS = dict(num_vectors=3000, dim=32, blocks_per_doc=50, seed=4)
# form -> (arena dtype, metric); the first two take the packed copy
FORMS = {"l2_packed": ("int8", "l2"), "ip_packed": ("int8", "ip"),
         "l2_unpacked": ("float32", "l2"), "l1_unpacked": ("float32", "l1")}
PARTS = ((0, 900), (900, 2000), (2000, 3000))
M, NQ, K, EF = 8, 48, 12, 24
RTOL = 1e-5
WAYS = ("fixed", "filtered", "iterative", "sampled")
LVP_N, LVP_NQ = 10_240, 64


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU ops on one thread: the graph searches run many small
    ops, which stall on a contended intra-op pool when other test workers
    share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    world = RefTreeGenerator(**WORLD).generate()
    corpus, _ = ref_corpus(**CORPUS)
    arenas = {}
    for form, (dtype, metric) in FORMS.items():
        ra = ref_arena(corpus, world, block_rows=1024, dtype=dtype,
                       metric=metric)
        arenas[form] = (ra, arena_from_reference(ra, "cpu"))
    rng = np.random.default_rng(9)
    q = rng.integers(0, 256, (NQ, corpus.dim)).astype(np.float32)
    masks = world.user_masks[rng.integers(0, world.num_users, NQ)]
    return dict(world=world, corpus=corpus, arenas=arenas, q=q, masks=masks)


def _search_kw(way, n_rows):
    entries = np.random.default_rng(1).integers(0, n_rows, NQ)
    return {"fixed": {}, "filtered": dict(filtered_traversal=True),
            "iterative": dict(iterative=True, entries=entries, max_steps=32),
            "sampled": dict(sampled_entry=True)}[way]


def _exact(got, want):
    """Equal ids and empty slots; finite distances within RTOL."""
    np.testing.assert_array_equal(got[1], want[1])
    fin = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), fin)
    np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=RTOL)


def _copy_state(ix):
    """A physical port index's copy on the host: (float32 rows as served
    of its nodes, norms and bitset words of every table row), by local
    id. A packed table's pad rows are zero codes, which serve no query
    (zero bits) and dequantize to the center, so their rows are left
    out."""
    if ix._table is not None:
        view = ix._copy_view()
        x, nrm, bits = view.gather(torch.arange(ix._table.shape[0]))
        return (x.numpy()[:ix.n_rows], nrm.numpy(),
                bits.numpy().view(np.uint32))
    return (ix._vectors.float().numpy()[:ix.n_rows], ix._norms.numpy(),
            ix._bits.numpy().view(np.uint32))


def _ref_copy_state(ref):
    """The reference's copy as its device arrays hold it."""
    return (np.asarray(ref._vectors, dtype=np.float32)[:ref.n_rows],
            np.asarray(ref._norms), np.asarray(ref._bits))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("part", [0, 1, 2, None])
def test_physical_index_matches_reference(setup, form, part):
    """HNSWIndex(logical=False) over one of three partitions (m 8), or the
    whole arena (rows=None, where the reference copies too): the port's
    own build equals the reference's graph; its copy holds the
    reference's values (packed on the lossless int8 arenas, unpacked on
    the float32 ones); the fixed, filtered, iterative (per-query entries)
    and sampled-entry searches return the reference's ids and distances."""
    s = setup
    ra, pa = s["arenas"][form]
    rows = None if part is None else np.arange(*PARTS[part])
    kw = dict(m=M, ef_construction=32, ef_search=EF, builder="classic",
              seed=part or 0)
    ref = RefHNSWIndex(ra, rows, logical=False, **kw)
    mine = HNSWIndex(pa, rows, **kw)
    assert not mine.logical and not ref.logical
    assert mine.use_packed == (FORMS[form][0] == "int8")
    assert (mine._table is not None) == mine.use_packed
    for key in ("neighbors", "entry"):
        np.testing.assert_array_equal(mine.graph_state()[key],
                                      ref.graph_state()[key])
    for a, b in zip(_copy_state(mine), _ref_copy_state(ref)):
        np.testing.assert_array_equal(a, b)
    for way in WAYS:
        skw = _search_kw(way, mine.n_rows)
        _exact(mine.search(s["q"], s["masks"], K, **skw),
               ref.search(s["q"], s["masks"], K, **skw))


@pytest.mark.parametrize("form", list(FORMS))
def test_physical_storage_is_its_copy(setup, form):
    """storage_bytes() of a physical index counts its copy under
    "vectors" (the packed table whole, or the unpacked rows) and its
    graph, row map and unpacked norms and bits under "index", the
    reference's structure (both > 0); a logical twin made from its
    graph_state() counts no vectors, holds no copy and returns the same
    ids and distances every way."""
    s = setup
    ra, pa = s["arenas"][form]
    rows = np.arange(*PARTS[1])
    ref = RefHNSWIndex(ra, rows, m=M, ef_construction=32, ef_search=EF,
                       builder="classic", logical=False)
    mine = HNSWIndex(pa, rows, m=M, ef_search=EF,
                     graph_state=ref.graph_state())
    npad, m0 = mine._hgraph.shape
    w = pa.role_bits.shape[1]
    got = mine.storage_bytes()
    if mine.use_packed:
        row_bytes = pa.quant.d_pad + 4 * w + 4
        assert mine._table.shape == (npad, row_bytes)
        assert got == {"vectors": npad * row_bytes,
                       "index": npad * (m0 * 4 + 4)}
    else:
        item = pa.vectors.element_size()
        assert got == {"vectors": npad * pa.dim * item,
                       "index": npad * (m0 * 4 + 4 + 4 * w + 4)}
        assert got == ref.storage_bytes()
    assert min(ref.storage_bytes().values()) > 0
    twin = HNSWIndex(pa, rows, m=M, ef_search=EF,
                     graph_state=mine.graph_state(), logical=True)
    assert twin.storage_bytes() == {"vectors": 0,
                                    "index": npad * (m0 * 4 + 4)}
    assert twin._table is None and twin._vectors is None
    for way in WAYS:
        skw = _search_kw(way, mine.n_rows)
        _exact(twin.search(s["q"], s["masks"], K, **skw),
               mine.search(s["q"], s["masks"], K, **skw))


MAINT_STEPS = ("insert_grows_to_2048", "refine", "delete", "double_delete",
               "insert_after_delete")


@pytest.mark.parametrize("form", ["l2_packed", "l2_unpacked"])
def test_physical_maintenance_matches_reference(setup, form):
    """A physical partition through insert_rows (crossing a power-of-two
    bucket), refine_rows, delete_rows (twice) and a second insert, beside
    the reference's physical index from the same graph: after each step
    the graph (host and device), row map, entry and copy (rows as served,
    norms, bits: new rows written, deleted rows' bits zeroed) equal the
    reference's, and the sampled-entry search returns its ids."""
    s = setup
    ra, pa = s["arenas"][form]
    ref = RefHNSWIndex(ra, np.arange(900), m=M, ef_construction=32,
                       ef_search=EF, builder="classic", logical=False)
    mine = HNSWIndex(pa, np.arange(900), m=M, ef_search=EF,
                     graph_state=ref.graph_state())
    rng = np.random.default_rng(3)
    dels = np.union1d(rng.choice(1900, 120, replace=False),
                      [ref._hrmap[ref.entry]])
    new = np.arange(900, 1900)
    steps = {
        "insert_grows_to_2048": lambda ix, a: ix.insert_rows(a, new),
        "refine": lambda ix, a: ix.refine_rows(a, new),
        "delete": lambda ix, a: ix.delete_rows(a, dels),
        "double_delete": lambda ix, a: ix.delete_rows(a, dels),
        "insert_after_delete": lambda ix, a: ix.insert_rows(
            a, np.arange(1900, 2300)),
    }
    for name in MAINT_STEPS:
        got, want = steps[name](mine, pa), steps[name](ref, ra)
        assert got == want, name
        assert mine.n_rows == ref.n_rows and mine.entry == ref.entry, name
        np.testing.assert_array_equal(mine._hgraph, np.asarray(ref._graph))
        np.testing.assert_array_equal(mine._graph.numpy(), mine._hgraph)
        np.testing.assert_array_equal(mine._hrmap, np.asarray(ref._row_map))
        np.testing.assert_array_equal(mine._hvec, ref._hvec)
        for a, b in zip(_copy_state(mine), _ref_copy_state(ref)):
            np.testing.assert_array_equal(a, b, err_msg=name)
        _exact(mine.search(s["q"], s["masks"], K, sampled_entry=True),
               ref.search(s["q"], s["masks"], K, sampled_entry=True))


def _cfgs():
    out = []
    for cfg in (RefFrameworkConfig(seed=0), port.FrameworkConfig(seed=0)):
        cfg.index.kind = "hnsw"
        cfg.index.hnsw_m = M
        cfg.index.hnsw_ef_construction = 32
        cfg.search.ef_search = EF
        cfg.search.batch_size = 64
        cfg.optimizer.topk = K
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def served():
    """Both packages' world and corpus (2,400 rows of 32 dimensions, 16
    roles), a workload of 48 queries and the int8 l2 arena (the served
    fixture of tests/test_torch_hnsw_metrics.py)."""
    kw = dict(num_users=80, num_roles=16, num_docs=120, h=3, b0=2, b1=2,
              seed=5)
    ckw = dict(num_vectors=2400, dim=32, blocks_per_doc=20, seed=4)
    rw = RefTreeGenerator(**kw).generate()
    rc, pool = ref_corpus(**ckw)
    pw = port.TreeRBACGenerator(**kw).generate()
    pc, _ = port.sift_like_corpus(**ckw)
    wl = ref_workload(rc, rw, num_queries=NQ, topk=K, zipf_param=0,
                      query_pool=pool, seed=1)
    ra = ref_arena(rc, rw, block_rows=1024, dtype="int8")
    return dict(rw=rw, rc=rc, pw=pw, pc=pc, wl=wl, ra=ra)


@pytest.mark.parametrize("name", ["rls", "role", "user", "qdtree"])
def test_default_config_builds_physical_partitions(served, name):
    """Under the default config (index.hnsw_logical False) RLS, ROLE, USER
    and QDTree over HNSW hold physical partitions in both packages, and
    both storage reports count partition vectors (the port's its packed
    tables: 148 bytes a row at d 128, here d_pad 128 + 4 + 4); the ids
    and distances are the reference's."""
    w = served
    rcfg, pcfg = _cfgs()
    assert rcfg.index.hnsw_logical is False and pcfg.index.hnsw_logical is False
    want_s = ref_searcher(name, w["rc"], w["rw"], w["ra"], rcfg)
    got_s = build_searcher(name, w["pc"], w["pw"],
                           arena_from_reference(w["ra"], "cpu"), pcfg)
    assert all(not p.index.logical for p in got_s.partitions.values())
    assert all(not p.index.logical for p in want_s.partitions.values())
    got_r, want_r = got_s.storage_report(), want_s.storage_report()
    assert got_r["partition_vectors_mb"] > 0
    assert want_r["partition_vectors_mb"] > 0
    copied = sum(p.index._table.numel() for p in got_s.partitions.values())
    assert got_r["partition_vectors_mb"] == copied / 2**20
    wl = w["wl"]
    got = got_s.search_batch(wl.vectors, wl.user_ids, w["pw"].user_masks, K)
    want = want_s.search_batch(wl.vectors, wl.user_ids, w["rw"].user_masks,
                               K)
    assert_same_topk(got, want, rtol=RTOL)
    assert_readable(w["pc"], w["pw"], got[1], wl.user_ids)


@pytest.mark.parametrize("kind", ["hnsw", "hybrid"])
def test_anonysys_graph_executors_stay_logical(served, kind):
    """AnonySys's kind-hnsw and hybrid executors set hnsw_logical on their
    graph config, as the reference's do: under the default config every
    graph partition is logical in both packages, the batcher holds them
    all and the partitions count no vector bytes."""
    w = served
    rcfg, pcfg = _cfgs()
    for cfg in (rcfg, pcfg):
        cfg.index.kind = kind
        cfg.optimizer.storage_alpha = 2.0
    want_s = ref_searcher("dynamic", w["rc"], w["rw"], w["ra"], rcfg,
                          packed=False)
    got_s = build_searcher("dynamic", w["pc"], w["pw"],
                           arena_from_reference(w["ra"], "cpu"), pcfg,
                           plan=plan_from_reference(want_s.plan),
                           packed=False)
    for s in (got_s, want_s):
        graphs = {pid for pid, p in s.partitions.items()
                  if type(p.index).__name__ == "HNSWIndex"}
        assert graphs and all(s.partitions[p].index.logical for p in graphs)
        assert s.graph_batcher.pids == graphs
    assert pcfg.index.hnsw_logical is False   # the caller's config kept
    assert all(got_s.partitions[p].index.storage_bytes()["vectors"] == 0
               for p in got_s.graph_batcher.pids)


def test_batchers_refuse_physical_partitions(setup):
    """The GraphProbeBatcher and the ShardedGraphSearcher take logical
    partitions only, with the reference's message; both take the logical
    twin."""
    _, pa = setup["arenas"]["l2_packed"]
    phys = HNSWIndex(pa, np.arange(*PARTS[0]), m=M, builder="classic")
    with pytest.raises(ValueError, match="needs logical-mode HNSW"):
        GraphProbeBatcher(pa, {0: phys})
    state = {"neighbors": phys._hgraph, "entry": phys.entry,
             "row_map": phys._hrmap, "logical": phys.logical}
    mesh = make_mesh(2, 1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="needs logical-mode HNSW"):
        ShardedGraphSearcher(pa, {0: state}, mesh)
    twin = HNSWIndex(pa, np.arange(*PARTS[0]), m=M,
                     graph_state=phys.graph_state(), logical=True)
    assert GraphProbeBatcher(pa, {0: twin}).pids == {0}
    assert ShardedGraphSearcher(pa, {0: dict(state, logical=True)},
                                mesh).pids == {0}


@pytest.mark.parametrize("builder", ["classic", "tpu"])
def test_role_graphs_equal_in_both_modes(setup, builder):
    """The script builds the role graphs once a mode with the same seeds;
    the builders are deterministic and independent of the mode, so both
    builds give the same graph (the runner builds once)."""
    _, pa = setup["arenas"]["l2_packed"]
    rows = np.arange(*PARTS[1])
    a, b = (HNSWIndex(pa, rows, m=M, seed=7, builder=builder, logical=lg)
            for lg in (True, False))
    for key in ("neighbors", "entry"):
        np.testing.assert_array_equal(a.graph_state()[key],
                                      b.graph_state()[key])


# ---- the runner

def _ref_role_searcher(rc, rw, ra, logical):
    """scripts/logical_vs_physical.py build_role_graph_searcher."""
    partitions = {}
    for role, docs in sorted(rw.role_to_docs.items()):
        rows = rc.rows_for_docs(np.fromiter(docs, dtype=np.int64,
                                            count=len(docs)))
        if not len(rows):
            continue
        idx = RefHNSWIndex(ra, rows, m=16, ef_construction=64,
                           ef_search=lvp.EF, query_batch=1024, seed=role,
                           logical=logical)
        partitions[role] = RefBuiltPartition(pid=role, rows=rows, index=idx,
                                             label=f"role_{role}")
    u2r = rw.user_to_roles
    s = RefPartitionedSearcher(
        ra, partitions, lambda uid: tuple(r for r in u2r.get(uid, ())
                                          if r in partitions), name="role")
    s.probe_params = lambda uid, pid: {"iterative": True,
                                       "ef_search": lvp.EF,
                                       "sampled_entry": True}
    if logical:
        s.graph_batcher = RefGraphProbeBatcher(
            ra, {pid: p.index for pid, p in partitions.items()})
    return s


def _ref_dynamic_searcher(rc, rw, ra, logical):
    """scripts/logical_vs_physical.py build_dynamic_graph_searcher."""
    cfg = RefFrameworkConfig(seed=0)
    cfg.index.kind = "hybrid"
    cfg.index.hnsw_m = 16
    cfg.index.hnsw_ef_construction = 64
    cfg.search.ef_search = lvp.EF
    cfg.optimizer.storage_alpha = 1.5
    cfg.optimizer.topk = lvp.K
    s = ref_dynamic(rc, rw, ra, cfg, packed=False)
    if not logical:
        if hasattr(s, "graph_batcher"):
            del s.graph_batcher
        for pid, p in s.partitions.items():
            if isinstance(p.index, RefHNSWIndex) and p.index.logical:
                p.index = RefHNSWIndex(
                    ra, p.rows, m=16, ef_construction=64, ef_search=lvp.EF,
                    query_batch=1024, seed=pid, logical=False,
                    graph_state=p.index.graph_state())
    else:
        for pid, p in s.partitions.items():
            if isinstance(p.index, RefInt8FlatIndex) \
                    and not p.index.logical and p.rows is not None:
                p.index = RefInt8FlatIndex(
                    ra, p.rows, query_batch=2048, block_rows=8192,
                    dist16=False, logical=True)
    return s


@pytest.fixture(scope="module")
def lvp_case():
    """The script's data at LVP_N rows and LVP_NQ queries in both
    packages, and the port's four arms, searched."""
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    data = lvp.make_data(LVP_N, LVP_NQ, cpu)
    rc, qpool = ref_corpus(num_vectors=LVP_N, blocks_per_doc=100, seed=0)
    rw = RefTreeGenerator(num_users=10_000, num_roles=100,
                          num_docs=rc.num_docs, h=4, b0=3, b1=4,
                          seed=0).generate()
    rng = np.random.default_rng(1)
    uids = rng.integers(0, 10_000, size=LVP_NQ)
    queries = qpool[rng.choice(len(qpool), LVP_NQ, replace=True)].astype(
        np.float32)
    ra = ref_arena(rc, rw, block_rows=131072, dtype="int8")
    wl = RefWorkload(vectors=queries, user_ids=uids, topk=lvp.K,
                     selectivities=np.zeros(LVP_NQ),
                     repetitions=np.ones(LVP_NQ))
    gt = ref_arena(rc, rw, block_rows=65536, dtype="float32", with_aug=False)
    truth = RefOracle(gt, block_rows=65536, query_batch=1024).compute(
        rc, rw, wl, lvp.K)
    phys = lvp.build_role_graphs(data)
    base = lvp.dynamic_base(data)
    arms = {"role_logical": lvp.role_searcher(data, phys, True),
            "role_physical": lvp.role_searcher(data, phys, False),
            "dynamic_logical": lvp.dynamic_searcher(data, base, True),
            "dynamic_physical": lvp.dynamic_searcher(data, base, False)}
    return dict(data=data, rc=rc, rw=rw, ra=ra, uids=uids, queries=queries,
                truth=truth, arms=arms)


def test_runner_data_is_the_scripts(lvp_case):
    """The runner's world, queries, users and truth are the script's."""
    c = lvp_case
    d = c["data"]
    np.testing.assert_array_equal(d["queries"], c["queries"])
    np.testing.assert_array_equal(d["uids"], c["uids"])
    np.testing.assert_array_equal(d["world"].user_masks, c["rw"].user_masks)
    np.testing.assert_array_equal(d["corpus"].vectors, c["rc"].vectors)
    np.testing.assert_array_equal(d["truth"], c["truth"])
    assert d["arena"].quant.lossless and d["arena"].n_padded == 131072


@pytest.mark.parametrize("arm", lvp.ARMS)
def test_runner_arm_matches_the_script(lvp_case, arm):
    """Each arm over the script's data: the same partitions, graphs and
    physical/logical split as the script's arm, the reference's ids and
    distances, and the same recall; the measured row carries the record's
    keys, and the storage split shows copies in the physical arms only."""
    c = lvp_case
    mine = c["arms"][arm]
    layout, mode = arm.split("_")
    build = _ref_role_searcher if layout == "role" else _ref_dynamic_searcher
    want_s = build(c["rc"], c["rw"], c["ra"], mode == "logical")
    assert sorted(mine.partitions) == sorted(want_s.partitions)
    for pid, p in mine.partitions.items():
        rp = want_s.partitions[pid].index
        assert type(p.index).__name__ == type(rp).__name__
        if type(rp).__name__ == "HNSWIndex":
            assert p.index.logical == rp.logical
            np.testing.assert_array_equal(p.index.graph_state()["neighbors"],
                                          rp.graph_state()["neighbors"])
        else:
            assert bool(p.index.logical) == bool(rp.logical)
    assert (getattr(mine, "graph_batcher", None) is None) == (
        getattr(want_s, "graph_batcher", None) is None)
    q, uids = c["queries"], c["uids"]
    got = mine.search_batch(q, uids, c["data"]["world"].user_masks, lvp.K)
    want = want_s.search_batch(q, uids, c["rw"].user_masks, lvp.K)
    assert_same_topk(got, want, rtol=RTOL)
    assert lvp.compute_recall(got[1], c["truth"]) == pytest.approx(
        ref_recall(want[1], c["truth"]), abs=1e-12)
    row = lvp.measure(arm, mine, c["data"], 0.0)
    for key in ("recall_at_10", "qps", "avg_latency_ms", "storage",
                "num_partitions", "build_s", "kernels"):
        assert key in row
    st = row["storage"]
    assert set(st) >= {"shared_vector_mb", "partition_vector_mb",
                       "partition_index_mb", "total_mb"}
    if arm == "role_physical":
        assert st["partition_vector_mb"] > 0
    if arm.endswith("logical"):
        assert st["partition_vector_mb"] == 0
    assert row["recall_at_10"] == round(ref_recall(want[1], c["truth"]), 4)


def test_runner_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    """An arm is checkpointed as it is measured; a rerun measures only the
    arms the checkpoint lacks, and one whose arms are all there builds
    nothing and prints the checkpointed record."""
    ck = str(tmp_path / "lvp.json")
    measured = []

    def fake_measure(name, searcher, data, build_s):
        measured.append(name)
        return {"recall_at_10": 1.0}

    monkeypatch.setattr(lvp, "measure", fake_measure)
    monkeypatch.setattr(lvp, "make_data", lambda n, nq, dev: {})
    monkeypatch.setattr(lvp, "build_role_graphs", lambda data: {})
    monkeypatch.setattr(lvp, "role_searcher", lambda data, base, lg: None)
    cpu = torch.device("cpu")
    out = lvp.run(["role_physical"], cpu, checkpoint=ck)
    assert measured == ["role_physical"] and "role_physical" in out
    saved = json.load(open(ck))
    assert saved["role_physical"]["hardware"] == "cpu"
    out = lvp.run(["role_logical", "role_physical"], cpu, out=saved,
                  checkpoint=ck)
    assert measured == ["role_physical", "role_logical"]

    def no_data(*a):
        raise AssertionError("a resumed run with every arm built data")

    monkeypatch.setattr(lvp, "make_data", no_data)
    assert lvp.main(["--arms", "role_logical", "role_physical",
                     "--checkpoint", ck, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"role_logical", "role_physical", "protocol",
            "hardware"} <= set(line)
    assert line["protocol"]["reference_record"].startswith(
        lvp.REFERENCE_RECORD)


def test_runner_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lvp.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_runner_imports_neither_jax_nor_the_reference():
    code = ("import sys; import vectorsearch_rbac_tpu_torch.bench."
            "logical_vs_physical; print(sorted(m for m in sys.modules if "
            "m == 'jax' or m.startswith(('jax.', 'vectorsearch_rbac_tpu.'))"
            " or m == 'vectorsearch_rbac_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
