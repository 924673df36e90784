"""HNSW's remaining paths against the JAX reference on the CPU: graph
scoring in l2, ip, cosine and l1, the ACORN filtered traversal and builder,
and HNSWIndex under RLS, ROLE, USER, QDTree and AnonySys.

Both packages compute on the same state: the port's arena comes from the
reference's through arena_from_reference, the graphs from the same native
builder. Four arenas over one SIFT-like corpus (3,000 rows of 32
dimensions, a tree world of 16 roles): int8 l2, int8 ip (lossless, so
packed rows), int8 cosine (lossy: its unit rows take the bfloat16 mirror)
and float32 l1. The reference runs its jitted searches on the CPU; the
port runs the plain versions of its graph kernels.

Tolerance: distances agree within 1e-5 relative to the case's largest
finite distance, and ids are equal but among distances within that
tolerance, which compare as sets (assert_same_topk, the ROADMAP tie
rule)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsearch_rbac_tpu.native as ref_native
import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu.bench.queries import (
    generate_query_workload as ref_workload)
from vectorsearch_rbac_tpu.core import bits_to_onehot8
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.core import (
    build_packed_graph_rows as ref_packed_rows)
from vectorsearch_rbac_tpu.core import (
    packed_query_operands as ref_packed_operands)
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.index.hnsw import HNSWIndex as RefHNSWIndex
from vectorsearch_rbac_tpu.ops.graph_search import (
    graph_search_filtered_fn, graph_search_fn, graph_search_iterative_fn)
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import (arena_from_reference,
                                         build_searcher, native)
from vectorsearch_rbac_tpu_torch.core import (build_packed_graph_rows,
                                              packed_query_operands)
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.ops.graph_search import (
    graph_beam_search, graph_beam_search_filtered,
    graph_beam_search_iterative, graph_beam_search_iterative_plain)
from vectorsearch_rbac_tpu_torch.ops.graph_step import (
    graph_score_packed, graph_score_packed_plain)
from vectorsearch_rbac_tpu_torch.partition.dynamic import plan_from_reference
from test_torch_packed import assert_readable, assert_same_topk

WORLD = dict(num_users=80, num_roles=16, num_docs=60, h=3, b0=2, b1=2,
             seed=5)
CORPUS = dict(num_vectors=3000, dim=32, blocks_per_doc=50, seed=4)
ARENAS = {"l2": "int8", "ip": "int8", "cosine": "int8", "l1": "float32"}
METRICS = list(ARENAS)
M, NQ, K, EF, STEPS = 8, 48, 12, 24, 32
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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
    for metric, dtype in ARENAS.items():
        ra = ref_arena(corpus, world, block_rows=1024, dtype=dtype,
                       metric=metric)
        arenas[metric] = (ra, arena_from_reference(ra, "cpu"))
    # one L2 graph over the rows (cosine's unit rows build their own)
    graphs = {}
    for metric, (ra, _) in arenas.items():
        nbr = ref_native.hnsw_build(ra.host_vectors[:ra.n], m=M,
                                    ef_construction=32, seed=1)[0]
        g = np.full((ra.n_padded, nbr.shape[1]), -1, np.int32)
        g[:ra.n] = nbr
        graphs[metric] = g
    rng = np.random.default_rng(9)
    qf = rng.integers(0, 256, (NQ, corpus.dim)).astype(np.float32)
    masks = world.user_masks[rng.integers(0, world.num_users, NQ)]
    entries = rng.integers(0, corpus.n, NQ).astype(np.int32)
    return dict(world=world, corpus=corpus, arenas=arenas, graphs=graphs,
                qf=qf, masks=masks, entries=entries)


def _unpacked_args(s, metric):
    ra, pa = s["arenas"][metric]
    g = s["graphs"][metric]
    jargs = (jnp.asarray(s["qf"]), ra.vectors, ra.norms, ra.role_bits,
             jnp.asarray(g), jnp.asarray(s["masks"]))
    pargs = (_t(s["qf"]), pa.vectors, pa.norms, pa.role_bits, _t(g),
             _t(s["masks"].view(np.int32)))
    return jargs, pargs


def _check(got, want, min_found=0.5):
    got = [a.numpy() if torch.is_tensor(a) else a for a in got]
    want = [np.asarray(a) for a in want]
    assert_same_topk(got, want, rtol=RTOL)
    assert (got[1] >= 0).mean() > min_found


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("filtered", [False, True],
                         ids=["fixed", "filtered"])
def test_fixed_and_filtered_traversals_match_reference(setup, metric,
                                                       filtered):
    """The fixed-budget beam (graph_search_fn) and the ACORN two-hop
    harvest over it (graph_search_filtered_fn) in each metric, from entry
    7 over the whole arena's graph: ids and distances (1e-5 relative) the
    reference's."""
    jargs, pargs = _unpacked_args(setup, metric)
    jfn, pfn = ((graph_search_filtered_fn, graph_beam_search_filtered)
                if filtered else (graph_search_fn, graph_beam_search))
    want = jfn(*jargs, 7, K, EF, metric=metric)
    got = pfn(*pargs, 7, K, EF, metric=metric)
    _check(got, want, 0.95 if filtered else 0.8)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("harvest", [False, True], ids=["1hop", "harvest"])
def test_iterative_step_loop_unpacked_matches_reference(setup, metric,
                                                        harvest):
    """The iterative rescan's plain step loop over the unpacked tables in
    each metric, with the 2-hop harvest on and off: ids and distances (1e-5
    relative) the reference's; graph_beam_search_iterative on CPU tensors
    is the same loop."""
    jargs, pargs = _unpacked_args(setup, metric)
    ent = setup["entries"]
    want = graph_search_iterative_fn(*jargs, jnp.asarray(ent), K, EF, STEPS,
                                     harvest, metric=metric)
    for fn in (graph_beam_search_iterative_plain,
               graph_beam_search_iterative):
        got = fn(*pargs, _t(ent), K, EF, STEPS, harvest, metric=metric)
        _check(got, want, 0.8)


def _packed_ip(s):
    ra, pa = s["arenas"]["ip"]
    assert ra.quant.lossless and pa.quant.lossless
    dqs, qcd = ref_packed_operands(ra, s["qf"])
    r_pad = ra.quant.r_pad
    jkw = dict(packed_rows=ref_packed_rows(ra), dq_scale=float(dqs),
               mask8=jnp.asarray(bits_to_onehot8(s["masks"], r_pad, r_pad)),
               q_center_dot=jnp.asarray(qcd))
    pdqs, pqcd = packed_query_operands(pa, s["qf"])
    pkw = dict(packed_rows=build_packed_graph_rows(pa), dq_scale=pdqs,
               q_center_dot=_t(pqcd))
    return jkw, pkw


@pytest.mark.parametrize("harvest", [False, True], ids=["1hop", "harvest"])
def test_iterative_packed_ip_matches_reference(setup, harvest):
    """Packed rows on the lossless int8 ip arena: the port's step loop
    (KS7's inner-product form in its plain version) against the reference's
    packed mode (mask8, dq_scale, q_center_dot): equal ids and distances
    (integer-valued data: every dot is exact)."""
    jargs, pargs = _unpacked_args(setup, "ip")
    jkw, pkw = _packed_ip(setup)
    ent = setup["entries"]
    want = graph_search_iterative_fn(*jargs, jnp.asarray(ent), K, EF, STEPS,
                                     harvest, metric="ip", **jkw)
    got = graph_beam_search_iterative_plain(*pargs, _t(ent), K, EF, STEPS,
                                            harvest, metric="ip", **pkw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[1] >= 0).float().mean() > 0.8


def test_packed_ip_score_matches_reference_score_admit(setup):
    """graph_score_packed_plain in ip (and its wrapper on CPU tensors)
    against the reference's packed score_admit, read through its iterative
    search with a step budget of 0 and each candidate as the entry (the
    result is the entry's score where it is admissible): equal scores,
    equal admit flags; -1 candidates score +inf, not admitted. l1 has no
    packed form."""
    s = setup
    jargs, pargs = _unpacked_args(s, "ip")
    jkw, pkw = _packed_ip(s)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, s["corpus"].n, (NQ, 6)).astype(np.int32)
    ids[:, 5] = -1
    qf = _t(np.pad(s["qf"], ((0, 0), (0, 128 - s["qf"].shape[1]))))
    args = (_t(ids), pkw["packed_rows"], qf, pargs[5], pkw["q_center_dot"],
            pkw["dq_scale"])
    got_s, got_ok = graph_score_packed_plain(*args, metric="ip")
    wrap_s, wrap_ok = graph_score_packed(*args, metric="ip")
    np.testing.assert_array_equal(wrap_s.numpy(), got_s.numpy())
    np.testing.assert_array_equal(wrap_ok.numpy(), got_ok.numpy())
    for c in range(5):
        wd, _ = graph_search_iterative_fn(
            *jargs, jnp.asarray(ids[:, c]), 1, EF, 1, metric="ip",
            step_budget=jnp.zeros(NQ, jnp.int32), **jkw)
        wd = np.asarray(wd)[:, 0]
        np.testing.assert_array_equal(got_ok[:, c].numpy(), np.isfinite(wd))
        ok = np.isfinite(wd)
        np.testing.assert_array_equal(got_s[:, c].numpy()[ok], wd[ok])
    assert got_ok[:, :5].any() and not got_ok[:, 5].any()
    assert torch.isinf(got_s[:, 5]).all()
    with pytest.raises(ValueError, match="no 'l1' form"):
        graph_score_packed_plain(*args, metric="l1")


def test_acorn_native_build_equals_reference(setup):
    """native.hnsw_build_acorn (the ACORN-gamma dense layer-0 lists): the
    reference's neighbours, levels, entry and top level for one seed, with
    lists m_beta wide and denser than the classic build's; the classic
    build, whose body now takes m_beta = 2m, stays the reference's."""
    vec = setup["arenas"]["l2"][0].host_vectors[:2000]
    got = native.hnsw_build_acorn(vec, m=M, m_beta=48, ef_construction=32,
                                  seed=11)
    want = ref_native.hnsw_build_acorn(vec, m=M, m_beta=48,
                                       ef_construction=32, seed=11)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    classic = native.hnsw_build(vec, m=M, ef_construction=32, seed=11)
    for a, b in zip(classic, ref_native.hnsw_build(vec, m=M,
                                                   ef_construction=32,
                                                   seed=11)):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (2000, 48)
    assert (got[0] >= 0).sum() > 1.5 * (classic[0] >= 0).sum()


@pytest.mark.parametrize("metric,builder", [
    ("ip", "classic"), ("ip", "tpu"), ("cosine", "classic"),
    ("l1", "classic"), ("l2", "acorn")])
def test_hnsw_index_matches_reference(setup, metric, builder):
    """HNSWIndex over a logical partition (rows 200-1,700) of each arena:
    the build (ip on the MIPS lift, cosine on unit rows, l1 on the L2
    proxy; the ACORN builder at m_beta 32) equals the reference's
    graph_state, and the fixed, filtered and sampled-entry searches (the
    sampled one alone on the "tpu" build) return the reference's ids
    (logical=True in both; tests/test_torch_physical.py holds
    the physical mode) and distances within 1e-5
    relative; the packed rows serve the lossless ip arena."""
    s = setup
    ra, pa = s["arenas"][metric]
    rows = np.arange(200, 1700)
    kw = dict(m=M, ef_construction=32, ef_search=EF, builder=builder,
              m_beta=32)
    ref = RefHNSWIndex(ra, rows, logical=True, **kw)
    mine = HNSWIndex(pa, rows, logical=True, **kw)
    assert mine.use_packed == ref.use_packed == (metric in ("l2", "ip"))
    for key in ("neighbors", "entry"):
        np.testing.assert_array_equal(mine.graph_state()[key],
                                      ref.graph_state()[key])
    ways = ({}, dict(filtered_traversal=True), dict(sampled_entry=True))
    # the "tpu" build's graph serves through the ip-classic case's code:
    # one way (the packed fused search's plain loop) suffices for it
    for search_kw in ways[2:] if builder == "tpu" else ways:
        want = ref.search(s["qf"], s["masks"], K, **search_kw)
        got = mine.search(s["qf"], s["masks"], K, **search_kw)
        assert_same_topk(got, want, rtol=RTOL)
        assert (got[1] >= 0).mean() > 0.5


def _ref_and_port_cfgs(kind="hnsw", m_beta=0):
    out = []
    for cfg in (RefFrameworkConfig(seed=0), port.FrameworkConfig(seed=0)):
        cfg.index.kind = kind
        cfg.index.hnsw_m = M
        cfg.index.hnsw_ef_construction = 32
        cfg.index.hnsw_m_beta = m_beta
        cfg.search.ef_search = EF
        cfg.search.batch_size = 64
        cfg.optimizer.topk = K
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def served():
    """Both packages' world and corpus (2,400 rows of 32 dimensions, 16
    roles) from the same seeds, a workload of 48 queries and the int8 l2
    arena."""
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
def test_strategies_over_hnsw_match_reference(served, name):
    """make_partition_index kind "hnsw" under RLS (one graph over the
    arena), ROLE, USER (a graph a partition, the unpacked layout) and
    QDTree (a graph a leaf, the tree built as the bench builds it): ids
    and distances (1e-5 relative) the reference's, every row readable."""
    w = served
    rcfg, pcfg = _ref_and_port_cfgs()
    want_s = ref_searcher(name, w["rc"], w["rw"], w["ra"], rcfg)
    got_s = build_searcher(name, w["pc"], w["pw"],
                           arena_from_reference(w["ra"], "cpu"), pcfg)
    assert all(type(p.index) is HNSWIndex for p in got_s.partitions.values())
    assert sorted(got_s.partitions) == sorted(want_s.partitions)
    wl = w["wl"]
    want = want_s.search_batch(wl.vectors, wl.user_ids, w["rw"].user_masks,
                               K)
    got = got_s.search_batch(wl.vectors, wl.user_ids, w["pw"].user_masks, K)
    assert_same_topk(got, want, rtol=RTOL)
    assert (got[1] >= 0).mean() > 0.5
    assert_readable(w["pc"], w["pw"], got[1], wl.user_ids)


def test_hybrid_kind_is_unknown_outside_anonysys(served):
    """Index kind "hybrid" is AnonySys's graph executor's: the factory
    raises the reference's ValueError for it under RLS."""
    _, pcfg = _ref_and_port_cfgs("hybrid")
    with pytest.raises(ValueError, match="unknown index kind"):
        build_searcher("rls", served["pc"], served["pw"],
                       arena_from_reference(served["ra"], "cpu"), pcfg)


def test_anonysys_with_acorn_builder_matches_reference(served):
    """AnonySys (index kind hnsw) with cfg.index.hnsw_m_beta 64: every
    partition an ACORN graph of 64-wide layer-0 lists, on the reference's
    plan; ids and distances (1e-5 relative) the reference's, every row
    readable."""
    w = served
    rcfg, pcfg = _ref_and_port_cfgs(m_beta=64)
    for cfg in (rcfg, pcfg):
        cfg.optimizer.storage_alpha = 2.0
    want_s = ref_searcher("dynamic", w["rc"], w["rw"], w["ra"], rcfg,
                          packed=False)
    got_s = build_searcher("dynamic", w["pc"], w["pw"],
                           arena_from_reference(w["ra"], "cpu"),
                           copy.deepcopy(pcfg),
                           plan=plan_from_reference(want_s.plan),
                           packed=False)
    for p in got_s.partitions.values():
        assert type(p.index) is HNSWIndex and p.index.builder == "acorn"
        assert p.index.graph_state()["neighbors"].shape[1] == 64
        np.testing.assert_array_equal(
            p.index.graph_state()["neighbors"],
            want_s.partitions[p.pid].index.graph_state()["neighbors"])
    wl = w["wl"]
    want = want_s.search_batch(wl.vectors, wl.user_ids, w["rw"].user_masks,
                               K)
    got = got_s.search_batch(wl.vectors, wl.user_ids, w["pw"].user_masks, K)
    assert_same_topk(got, want, rtol=RTOL)
    assert (got[1] >= 0).mean() > 0.5
    assert_readable(w["pc"], w["pw"], got[1], wl.user_ids)
