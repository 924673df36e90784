"""The port's HNSW graph executor against the JAX reference on the CPU.

Both packages compute on the same state: the port's arena comes from the
reference's through arena_from_reference, its graphs from the same native
builder (or from the JAX index's graph_state), its AnonySys plan through
plan_from_reference. The reference runs its jitted graph search on the
CPU; the port runs the plain versions of its graph-step kernels. On the
SIFT-like (integer-valued, lossless) data every distance is exact, so ids
and distances must be equal; where a comparison crosses the host merge of
several partitions, ids are compared as sets among equal distances."""

import copy
import os

import jax
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
    graph_search_fn, graph_search_iterative_fn)
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch import native
from vectorsearch_rbac_tpu_torch.core import (build_packed_graph_rows,
                                              packed_query_operands)
from vectorsearch_rbac_tpu_torch.index import hnsw as hnsw_mod
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.ops import _build, graph_search
from vectorsearch_rbac_tpu_torch.ops.graph_search import (
    graph_beam_search, graph_beam_search_iterative,
    graph_beam_search_iterative_plain)
from vectorsearch_rbac_tpu_torch.ops.graph_step import (
    graph_merge_step, graph_merge_step_plain, graph_score_packed)
from vectorsearch_rbac_tpu_torch.partition.dynamic import plan_from_reference
from vectorsearch_rbac_tpu_torch.partition.graph_batch import (
    GraphProbeBatcher)

WORLD = dict(num_users=80, num_roles=16, num_docs=60, h=3, b0=2, b1=2,
             seed=5)
CORPUS = dict(num_vectors=3000, dim=32, blocks_per_doc=50, seed=4)
PARTS = [(0, 1000), (1000, 1700), (1700, 3000)]
M, NQ, K, EF, STEPS = 8, 48, 12, 24, 32


@pytest.fixture(scope="module")
def setup():
    world = RefTreeGenerator(**WORLD).generate()
    corpus, _ = ref_corpus(**CORPUS)
    ra = ref_arena(corpus, world, block_rows=1024, dtype="int8")
    pa = arena_from_reference(ra, "cpu")
    vec = ra.host_vectors
    graphs = [ref_native.hnsw_build(vec[a:b], m=M, ef_construction=32,
                                    seed=3) for a, b in PARTS]
    rng = np.random.default_rng(9)
    qf = rng.integers(0, 256, (NQ, corpus.dim)).astype(np.float32)
    users = rng.integers(0, world.num_users, NQ)
    masks = world.user_masks[users]
    return dict(world=world, corpus=corpus, ra=ra, pa=pa, graphs=graphs,
                qf=qf, masks=masks, rng=rng)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _slab(graphs, n_class):
    m0 = graphs[0][0].shape[1]
    g3 = np.full((len(graphs), n_class, m0), -1, np.int32)
    rm2 = np.full((len(graphs), n_class), -1, np.int32)
    for p, ((a, b), (nbr, _, _, _)) in enumerate(zip(PARTS, graphs)):
        g3[p, :b - a] = nbr
        rm2[p, :b - a] = np.arange(a, b)
    return g3, rm2


def _iterative_case(s, mode, packed, harvest, budget):
    """(jax kwargs, port kwargs) of one iterative search on shared inputs:
    the whole arena's graph, one logical partition, or the three-graph
    slab with per-query slots."""
    rng = np.random.default_rng(hash((mode, packed, harvest, budget)) % 2**32)
    ra, pa = s["ra"], s["pa"]
    j, p = {}, {}
    if mode == "whole":
        nbr = ref_native.hnsw_build(ra.host_vectors[:ra.n], m=M,
                                    ef_construction=32, seed=1)[0]
        graph = np.full((ra.n_padded, nbr.shape[1]), -1, np.int32)
        graph[:ra.n] = nbr
        entries = rng.integers(0, ra.n, NQ).astype(np.int32)
    elif mode == "logical":
        nbr = s["graphs"][0][0]
        graph = np.full((1024, nbr.shape[1]), -1, np.int32)
        graph[:len(nbr)] = nbr
        rm = np.full(1024, -1, np.int32)
        rm[:len(nbr)] = np.arange(len(nbr))
        j["row_map"], p["row_map"] = jnp.asarray(rm), _t(rm)
        entries = rng.integers(0, len(nbr), NQ).astype(np.int32)
    else:
        graph, rm2 = _slab(s["graphs"], 2048)
        pids = rng.integers(0, len(PARTS), NQ).astype(np.int32)
        sizes = np.array([b - a for a, b in PARTS])
        entries = (rng.random(NQ) * sizes[pids]).astype(np.int32)
        j["row_map"], p["row_map"] = jnp.asarray(rm2), _t(rm2)
        j["pids"], p["pids"] = jnp.asarray(pids), _t(pids)
    if budget:
        sb = rng.choice([4, 8, 16, STEPS], NQ).astype(np.int32)
        j["step_budget"], p["step_budget"] = jnp.asarray(sb), _t(sb)
    if packed:
        dqs, qcd = ref_packed_operands(ra, s["qf"])
        r_pad = ra.quant.r_pad
        j.update(packed_rows=ref_packed_rows(ra), dq_scale=float(dqs),
                 mask8=jnp.asarray(bits_to_onehot8(s["masks"], r_pad, r_pad)),
                 q_center_dot=jnp.asarray(qcd))
        pdqs, pqcd = packed_query_operands(pa, s["qf"])
        p.update(packed_rows=build_packed_graph_rows(pa), dq_scale=pdqs,
                 q_center_dot=_t(pqcd))
    return graph, entries, j, p


CASES = [("whole", False, False, False), ("logical", True, False, False),
         ("multi", True, False, True), ("multi", False, True, True),
         ("multi", True, True, True), ("multi", True, True, False)]


def _run_both(s, case, fn=graph_beam_search_iterative, **port_kw):
    mode, packed, harvest, budget = case
    graph, entries, jkw, pkw = _iterative_case(s, *case)
    ra, pa = s["ra"], s["pa"]
    want = graph_search_iterative_fn(
        jnp.asarray(s["qf"]), ra.vectors, ra.norms, ra.role_bits,
        jnp.asarray(graph), jnp.asarray(s["masks"]), jnp.asarray(entries),
        K, EF, STEPS, harvest, **jkw)
    got = fn(
        _t(s["qf"]), pa.vectors, pa.norms, pa.role_bits, _t(graph),
        _t(s["masks"].view(np.int32)), _t(entries), K, EF, STEPS, harvest,
        **pkw, **port_kw)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("fn", [graph_beam_search_iterative,
                                graph_beam_search_iterative_plain],
                         ids=["search", "plain"])
@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_iterative_search_matches_reference(setup, case, fn):
    """graph_beam_search_iterative and its plain loop (the fused kernel's
    plain version): packed and unpacked scoring, one graph (whole arena
    or logical) and the multi-graph slab with per-query step budgets, the
    2-hop harvest on and off: equal ids, equal distances."""
    (wd, wi), (gd, gi) = _run_both(setup, case, fn)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert (gi >= 0).sum() > 0.5 * gi.size


@pytest.fixture(scope="module")
def wide_setup():
    """setup's searches in a tree world of 1,100 roles (35 bitset words,
    past the 1,024 roles of the first graph kernels' lane-a-word test),
    over 1,500 documents of 2 rows."""
    world = RefTreeGenerator(num_users=2200, num_roles=1100, num_docs=1500,
                             h=3, b0=2, b1=2, seed=5).generate()
    corpus, _ = ref_corpus(**{**CORPUS, "blocks_per_doc": 2})
    ra = ref_arena(corpus, world, block_rows=1024, dtype="int8")
    pa = arena_from_reference(ra, "cpu")
    graphs = [ref_native.hnsw_build(ra.host_vectors[a:b], m=M,
                                    ef_construction=32, seed=3)
              for a, b in PARTS]
    rng = np.random.default_rng(9)
    qf = rng.integers(0, 256, (NQ, corpus.dim)).astype(np.float32)
    # each query holds the roles of 40 users: a user alone reads a handful
    # of rows in this world
    masks = np.bitwise_or.reduce(world.user_masks[rng.integers(
        0, world.num_users, (NQ, 40))], axis=1)
    return dict(world=world, corpus=corpus, ra=ra, pa=pa, graphs=graphs,
                qf=qf, masks=masks, rng=rng)


@pytest.mark.parametrize("case", [CASES[2], CASES[4]],
                         ids=["packed-budget", "packed-harvest"])
def test_hybrid_plain_loop_matches_reference_past_1024_roles(wide_setup,
                                                             case):
    """The hybrid executor's packed search (the multi-graph slab, step
    budgets, with and without the harvest) through its plain loop in a
    world of 1,100 roles: equal ids and distances to the reference's."""
    assert wide_setup["pa"].role_bits.shape[1] == 35
    assert (wide_setup["masks"][:, 32:] != 0).any()
    (wd, wi), (gd, gi) = _run_both(wide_setup, case,
                                   graph_beam_search_iterative_plain)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert (gi >= 0).sum() > 0.15 * gi.size


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[4]],
                         ids=["packed-logical", "packed-budget",
                              "packed-harvest"])
def test_cpu_search_is_the_plain_loop(setup, case, monkeypatch):
    """On CPU tensors every combination (the fused kernel's packed path
    included) runs the step loop, with the step kernels' plain versions:
    graph_beam_search_iterative equals graph_beam_search_iterative_plain,
    and so does graph_search_fused where it applies; no kernel launches
    and no fused launch is tried."""
    def refuse(*a, **k):
        raise AssertionError("the fused search was called on CPU tensors")

    before = dict(_build.LAUNCHES)
    _, (gd, gi) = _run_both(setup, case)
    monkeypatch.setattr(graph_search, "graph_search_fused", refuse)
    _, (pd, pi) = _run_both(setup, case, graph_beam_search_iterative)
    _, (qd, qi) = _run_both(setup, case, graph_beam_search_iterative_plain)
    for a, b in ((gd, qd), (gi, qi), (pd, qd), (pi, qi)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.undo()
    if not case[2]:                              # no harvest: fused applies
        graph, entries, _, pkw = _iterative_case(setup, *case)
        stats = torch.zeros(2, dtype=torch.int64)
        fd, fi = graph_search.graph_search_fused(
            _t(setup["qf"]), _t(graph), _t(setup["masks"].view(np.int32)),
            _t(entries), K, EF, STEPS, **pkw, stats=stats)
        np.testing.assert_array_equal(fi.numpy(), qi)
        np.testing.assert_array_equal(fd.numpy(), qd)
        assert 0 < stats[0] <= NQ * STEPS and stats[1] > stats[0]
    assert dict(_build.LAUNCHES) == before


class _OnDevice:
    """Stands in for a tensor on `device` of the given shape."""

    def __init__(self, device, *shape):
        self.device, self.shape = torch.device(device), shape


@pytest.mark.parametrize("packed,harvest,device,shape,fused", [
    (True, False, "cuda", {}, True), (True, True, "cuda", {}, False),
    (False, False, "cuda", {}, False), (True, False, "cpu", {}, False),
    # shapes outside the fused kernel's take the step loop on the card
    (True, False, "cuda", dict(ef=1024), False),
    (True, False, "cuda", dict(m0=96), False),
    (True, False, "cuda", dict(steps=8192), False),
    (True, False, "cuda", dict(d_pad=512), False),
    (True, False, "cuda", dict(k=EF + 1), False),
    (False, False, "cuda", dict(w=40), False),      # unpacked: any W
])
def test_only_the_packed_path_on_the_card_is_fused(packed, harvest, device,
                                                   shape, fused,
                                                   monkeypatch):
    """The dispatch: only packed rows without the 2-hop harvest on CUDA
    tensors, at a shape the fused kernel takes, go to the fused kernel;
    the harvest, the unpacked scorer and every other shape keep the step
    loop (KS7 and KS6 on the card)."""
    taken = []
    monkeypatch.setattr(graph_search, "graph_search_fused",
                        lambda *a, **k: taken.append("fused"))
    monkeypatch.setattr(graph_search, "_step_loop",
                        lambda *a, **k: taken.append("steps"))
    sh = {**dict(ef=EF, m0=16, steps=STEPS, d_pad=128, k=K, w=4), **shape}
    graph_beam_search_iterative(
        _OnDevice(device, NQ, 32), None, None, None,
        _OnDevice(device, 3, 2048, sh["m0"]), _OnDevice(device, NQ, sh["w"]),
        None, sh["k"], sh["ef"], sh["steps"], harvest,
        packed_rows=(_OnDevice(device, 4096, sh["d_pad"] + 4 * sh["w"] + 4)
                     if packed else None))
    assert taken == ["fused" if fused else "steps"]


@pytest.mark.parametrize("w,d_pad", [(32, 128), (64, 128), (4, 1152)])
@pytest.mark.parametrize("harvest", [False, True])
def test_wide_worlds_raise_on_the_card(harvest, w, d_pad, monkeypatch):
    """32 bitset words or more, and packed rows past d_pad 1024, on the
    card: nothing raises. Without the harvest, 32 and 64 words reach the
    fused search (its role test loops past 32 words); d_pad 1152 (past the
    fused kernel's d_pads) and the harvest take the step loop, whose KS7
    takes any W and d_pad."""
    taken = []
    monkeypatch.setattr(graph_search, "graph_search_fused",
                        lambda *a, **k: taken.append("fused"))
    monkeypatch.setattr(graph_search, "_step_loop",
                        lambda *a, **k: taken.append("steps"))
    graph_beam_search_iterative(
        _OnDevice("cuda", NQ, 32), None, None, None,
        _OnDevice("cuda", 3, 2048, 16), _OnDevice("cuda", NQ, w), None,
        K, EF, STEPS, harvest,
        packed_rows=_OnDevice("cuda", 4096, d_pad + 4 * w + 4))
    assert taken == ["steps" if harvest or d_pad > 768 else "fused"]


@pytest.mark.parametrize("name,value,ok", [
    ("w", 31, True), ("w", 32, True), ("w", 0, False),
    ("d_pad", 768, True), ("d_pad", 512, False), ("d_pad", 1024, False),
    ("m0", 64, True), ("m0", 65, False),
    ("ef", 512, True), ("ef", 513, False),
    ("k", 24, True), ("k", 25, False),
    ("max_steps", 4096, True), ("max_steps", 4097, False),
])
def test_fused_shape_predicate(name, value, ok):
    """fused_shape_problems on both sides of each of the kernel's limits
    (every other dimension at the hybrid cell's shape), naming what it
    refuses."""
    shape = {**dict(w=4, d_pad=128, d=32, m0=32, k=K, ef=EF, max_steps=64),
             name: value}
    problems = graph_search.fused_shape_problems(**shape)
    assert (problems == []) == ok, problems
    if name == "d_pad" and not ok:
        assert "d_pad" in problems[0]


def test_fused_search_refuses_other_shapes(setup):
    """graph_search_fused takes the kernel's shapes only, on any device:
    ef <= 512, k <= ef, M0 <= 64, max_steps <= 4096, d_pad 128/256/768."""
    graph, entries, _, pkw = _iterative_case(setup, "multi", True, False,
                                             False)
    args = (_t(setup["qf"]), _t(graph), _t(setup["masks"].view(np.int32)),
            _t(entries))
    for k, ef, steps, g in ((K, 1024, STEPS, args[1]), (EF + 1, EF, STEPS,
                            args[1]), (K, EF, 5000, args[1]),
                            (K, EF, STEPS, args[1].repeat(1, 1, 9))):
        with pytest.raises(ValueError, match="graph_search_fused"):
            graph_search.graph_search_fused(args[0], g, *args[2:], k, ef,
                                            steps, **pkw)
    code = pkw["packed_rows"][:, :-4 - 4 * setup["masks"].shape[1]]
    with pytest.raises(ValueError, match="d_pad 384"):
        graph_search.graph_search_fused(*args, K, EF, STEPS, **{
            **pkw, "packed_rows": torch.cat([code, code, pkw["packed_rows"]],
                                            1)})


@pytest.mark.parametrize("case", [CASES[2], CASES[4]],
                         ids=["packed-budget", "packed-harvest"])
def test_sync_cadence_gives_identical_outputs(setup, case):
    """The done test read every N steps gives what it gives at every step
    (N = 1): a done query's extra steps move nothing it returns."""
    _, (d1, i1) = _run_both(setup, case, sync_every=1)
    for n in (3, 8, 64):
        _, (dn, i_n) = _run_both(setup, case, sync_every=n)
        np.testing.assert_array_equal(i_n, i1)
        np.testing.assert_array_equal(dn, d1)


@pytest.mark.parametrize("logical", [False, True], ids=["whole", "logical"])
def test_beam_search_matches_reference(setup, logical):
    """graph_beam_search, the fixed-budget traversal of the builder's
    refinement pass, over the arena's bfloat16 mirror."""
    s = setup
    ra, pa = s["ra"], s["pa"]
    nbr = s["graphs"][0][0]
    graph = np.full((ra.n_padded if not logical else 1024, nbr.shape[1]), -1,
                    np.int32)
    graph[:len(nbr)] = nbr
    rm = np.full(graph.shape[0], -1, np.int32)
    rm[:len(nbr)] = np.arange(len(nbr)) + (500 if logical else 0)
    want = graph_search_fn(jnp.asarray(s["qf"]), ra.vectors, ra.norms,
                           ra.role_bits, jnp.asarray(graph),
                           jnp.asarray(s["masks"]), 7, K, EF,
                           row_map=jnp.asarray(rm) if logical else None)
    got = graph_beam_search(_t(s["qf"]), pa.vectors, pa.norms, pa.role_bits,
                            _t(graph), _t(s["masks"].view(np.int32)), 7, K,
                            EF, row_map=_t(rm) if logical else None)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def _jax_merges(beam_d, beam_ids, nd, nb, w_d, res_d, res_ids, cand_d,
                cand_ids):
    """The three merges of the reference's iterative body (:552-603)."""
    ef, kk = beam_d.shape[1], res_d.shape[1]
    all_ids = jnp.concatenate([beam_ids, nb], axis=1)
    neg, pos = jax.lax.top_k(-jnp.concatenate([beam_d, nd], axis=1), ef)
    out = [-neg, jnp.take_along_axis(all_ids, pos, axis=1)]
    neg_w, _ = jax.lax.top_k(-jnp.concatenate([w_d, nd], axis=1), ef)
    out.append(-neg_w)
    r_ids = jnp.concatenate([res_ids, cand_ids], axis=1)
    neg, pos = jax.lax.top_k(-jnp.concatenate([res_d, cand_d], axis=1), kk)
    out += [-neg, jnp.take_along_axis(r_ids, pos, axis=1)]
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("ef,c,kk,cr", [(16, 8, 10, 8), (32, 16, 18, 34),
                                        (64, 32, 18, 32), (24, 13, 7, 20)])
def test_merge_step_matches_reference_body(ef, c, kk, cr):
    """The plain graph_merge_step (and its wrapper on CPU tensors) equals
    one step's merges of the reference's body: small integer values, so
    ties everywhere, +inf pads, and a popped beam slot."""
    rng = np.random.default_rng(ef + c)
    q = 40

    def vals(w):
        v = rng.integers(0, 6, (q, w)).astype(np.float32)
        v[rng.random((q, w)) < 0.3] = np.inf
        return v

    ids = lambda w: rng.integers(-1, 500, (q, w)).astype(np.int32)
    beam_d = np.sort(vals(ef), axis=1)
    beam_d[:, 0] = np.inf
    ins = [beam_d, ids(ef), vals(c), ids(c), np.sort(vals(ef), axis=1),
           np.sort(vals(kk), axis=1), ids(kk), vals(cr), ids(cr)]
    want = _jax_merges(*[jnp.asarray(a) for a in ins])
    for fn in (graph_merge_step_plain, graph_merge_step):
        got = fn(*[_t(a) for a in ins])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_score_wrapper_on_cpu_is_the_plain_version(setup):
    """graph_score_packed on CPU tensors: invalid ids give +inf / False;
    shapes that do not pair up raise."""
    s = setup
    pa = s["pa"]
    packed = build_packed_graph_rows(pa)
    assert packed.shape == (pa.n_padded, 128 + 4 * pa.role_bits.shape[1]
                            + 4)
    ids = _t(np.array([[0, -1, 5], [2999, 7, -1]], np.int32))
    qf = torch.zeros((2, 128))
    qf[:, :32] = _t(s["qf"][:2])
    dqs, qcd = packed_query_operands(pa, s["qf"][:2])
    sc, ok = graph_score_packed(ids, packed, qf,
                                _t(s["masks"][:2].view(np.int32)), _t(qcd),
                                dqs)
    assert torch.isinf(sc[0, 1]) and not ok[0, 1] and not ok[1, 2]
    x = torch.from_numpy(pa.host_vectors[[0, 5, 2999, 7]])
    want = ((x - _t(s["qf"][[0, 0, 1, 1]])) ** 2).sum(1) \
        - (_t(s["qf"][[0, 0, 1, 1]]) ** 2).sum(1)
    np.testing.assert_array_equal(sc[[0, 0, 1, 1], [0, 2, 0, 1]].numpy(),
                                  want.numpy())
    with pytest.raises(ValueError, match="graph_score_packed"):
        graph_score_packed(ids, packed, qf[:, :64],
                           _t(s["masks"][:2].view(np.int32)), _t(qcd), dqs)


def test_native_builds_equal_the_reference(setup):
    """The port's copy of the native builder gives the reference's arrays
    for one seed: vsr_hnsw_build, vsr_hnsw_build_acorn, vsr_rng_prune, and
    vsr_insert_update fed the same candidates (insert mode: nodes 1000-1499
    after a graph over 1000 rows, through a row map; refine mode over 300
    existing nodes) gives the reference's graph and changed rows."""
    vec = setup["ra"].host_vectors[:1500]
    for build, kw in ((native.hnsw_build, {}),
                      (native.hnsw_build_acorn, dict(m_beta=40))):
        got = build(vec, m=M, seed=11, **kw)
        want = getattr(ref_native, build.__name__)(vec, m=M, seed=11, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    knn = np.random.default_rng(2).integers(0, 1500, (1500, 40)).astype(
        np.int32)
    np.testing.assert_array_equal(
        native.rng_prune(vec, knn, m=M, alpha=1.2),
        ref_native.rng_prune(vec, knn, m=M, alpha=1.2))
    rng = np.random.default_rng(4)
    table = setup["ra"].host_vectors
    vmap = np.full(2048, -1, np.int32)
    vmap[:1500] = rng.permutation(len(table))[:1500]
    graph = np.full((2048, 2 * M), -1, np.int32)
    graph[:1000] = ref_native.hnsw_build(table[vmap[:1000]], m=M, seed=3)[0]
    cand = rng.integers(-1, 1000, (500, 24)).astype(np.int32)
    nodes = rng.choice(1500, 300, replace=False).astype(np.int32)
    refine_cand = rng.integers(-1, 1500, (300, 24)).astype(np.int32)
    got_g, want_g = graph.copy(), graph.copy()
    for mode in ("insert", "refine"):
        args, kw = ((cand, 1000, M), {}) if mode == "insert" else (
            (refine_cand, 1500, M), dict(nodes=nodes))
        got = native.insert_update(table, vmap, got_g, *args, alpha=1.2, **kw)
        want = ref_native.insert_update(table, vmap, want_g, *args,
                                        alpha=1.2, **kw)
        np.testing.assert_array_equal(got, want, err_msg=mode)
        np.testing.assert_array_equal(got_g, want_g, err_msg=mode)
        assert len(got) and not np.array_equal(got_g, graph)


def test_threaded_rng_prune_equals_the_reference():
    """vsr_rng_prune's per-node pass over node ranges in threads (one a
    4,096 nodes, up to one a hardware thread): on 20,000 nodes the port's
    prune gives the reference's one-thread arrays."""
    rng = np.random.default_rng(5)
    vec = rng.normal(0, 1, (20_000, 16)).astype(np.float32)
    knn = rng.integers(-1, 20_000, (20_000, 24)).astype(np.int32)
    np.testing.assert_array_equal(
        native.rng_prune(vec, knn, m=M, alpha=1.2),
        ref_native.rng_prune(vec, knn, m=M, alpha=1.2))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native HNSW builder"):
        native.lib()


@pytest.mark.parametrize("builder", ["classic", "tpu"])
def test_hnsw_index_matches_reference(setup, builder):
    """HNSWIndex over a logical partition: the port's own build equals the
    JAX index's graph (both builders), and the index fed the JAX index's
    graph_state returns the JAX index's ids and distances, through the
    fixed beam, the iterative rescan with per-query entries and the
    sampled entries."""
    s = setup
    rows = np.arange(200, 1500)
    kw = dict(m=M, ef_construction=32, ef_search=EF, builder=builder)
    ref = RefHNSWIndex(s["ra"], rows, logical=True, **kw)
    mine = HNSWIndex(s["pa"], rows, logical=True, **kw)
    state = ref.graph_state()
    for key in ("neighbors", "entry"):
        np.testing.assert_array_equal(mine.graph_state()[key], state[key])
    fed = HNSWIndex(s["pa"], rows, m=M, ef_search=EF, graph_state=state,
                    logical=True)
    assert fed.storage_bytes() == ref.storage_bytes()
    entries = np.random.default_rng(1).integers(0, len(rows), NQ)
    for search_kw in ({}, dict(iterative=True, entries=entries,
                               max_steps=16),
                      dict(sampled_entry=True)):
        want = ref.search(s["qf"], s["masks"], K, **search_kw)
        got = fed.search(s["qf"], s["masks"], K, **search_kw)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_hnsw_index_refuses_what_is_not_ported(setup, monkeypatch):
    """Above KNN_MAX_ROWS (patched down to 1,000) the "tpu" builder takes
    the IVF-assisted kNN and the graph serves: every row in the graph, the
    self-search of the rows finds most rows themselves. The ACORN builder,
    the filtered traversal and ip graph scoring, once refused, now serve
    (tests/test_torch_hnsw_metrics.py holds them to the reference); what
    is still refused is an unknown builder, an unknown metric and l1 over
    packed rows."""
    rows = np.arange(0, 1200)
    monkeypatch.setattr(hnsw_mod, "KNN_MAX_ROWS", 1000)
    calls = []
    ivf_knn = hnsw_mod._device_knn_graph_ivf

    def spy(vec, k, device, **kw):
        calls.append(len(vec))
        return ivf_knn(vec, k, device, **kw)

    monkeypatch.setattr(hnsw_mod, "_device_knn_graph_ivf", spy)
    ix = HNSWIndex(setup["pa"], rows, m=M, builder="tpu")
    assert calls == [len(rows)] and ix.builder == "tpu"
    nbr = ix.graph_state()["neighbors"]
    assert nbr.shape[0] == len(rows) and (nbr >= 0).sum(1).min() > 0
    q = setup["pa"].host_vectors[rows[:64]]
    masks = np.full((64, setup["pa"].role_bits.shape[1]), 0xFFFFFFFF,
                    np.uint32)
    _, ids = ix.search(q, masks, 1, iterative=True, ef_search=EF)
    assert (ids[:, 0] == rows[:64]).mean() > 0.9
    acorn = HNSWIndex(setup["pa"], rows, m=M, builder="acorn", m_beta=32)
    assert acorn.graph_state()["neighbors"].shape == (len(rows), 32)
    ix = HNSWIndex(setup["pa"], rows[:300], m=M)
    _, ids = ix.search(setup["qf"], setup["masks"], K,
                       filtered_traversal=True)
    assert (ids >= 0).mean() > 0.5
    _, ids = graph_beam_search(_t(setup["qf"]), setup["pa"].vectors,
                               setup["pa"].norms, setup["pa"].role_bits,
                               ix._graph, _t(setup["masks"].view(np.int32)),
                               0, K, EF, row_map=ix._row_map, metric="ip")
    assert (ids >= 0).float().mean() > 0.5
    with pytest.raises(ValueError, match="unknown builder"):
        HNSWIndex(setup["pa"], rows, m=M, builder="vamana")
    with pytest.raises(ValueError, match="metric 'hamming'"):
        graph_beam_search(_t(setup["qf"]), None, None, None, ix._graph,
                          None, 0, K, EF, metric="hamming")
    graph, entries, _, pkw = _iterative_case(setup, "logical", True, False,
                                             False)
    with pytest.raises(ValueError, match="no 'l1' form"):
        graph_beam_search_iterative(
            _t(setup["qf"]), None, None, None, _t(graph),
            _t(setup["masks"].view(np.int32)), _t(entries), K, EF, STEPS,
            metric="l1", **pkw)


@pytest.fixture(scope="module")
def hybrid():
    """The reference's and the port's hybrid AnonySys searchers on one
    plan over a 20,000-row SIFT-like corpus (tree RBAC, 100 roles): the
    graph partitions all take the classic builder (< 50k rows)."""
    corpus, pool = ref_corpus(num_vectors=20000, blocks_per_doc=100, seed=0)
    world = RefTreeGenerator(num_users=2000, num_roles=100,
                             num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                             seed=0).generate()
    ra = ref_arena(corpus, world, block_rows=16384, dtype="int8")
    wl = ref_workload(corpus, world, num_queries=96, topk=10, zipf_param=0,
                      query_pool=pool, seed=1)
    cfgs = []
    for cfg in (RefFrameworkConfig(seed=0), port.FrameworkConfig(seed=0)):
        cfg.index.kind = "hybrid"
        cfg.search.ef_search = 40
        cfg.search.batch_size = 1024
        cfg.optimizer.storage_alpha = 2.0
        cfg.optimizer.topk = 10
        cfgs.append(cfg)
    want_s = ref_searcher("dynamic", corpus, world, ra, cfgs[0],
                          packed=False)
    pw = port.TreeRBACGenerator(num_users=2000, num_roles=100,
                                num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                                seed=0).generate()
    pc, _ = port.sift_like_corpus(num_vectors=20000, blocks_per_doc=100,
                                  seed=0)
    got_s = build_searcher("dynamic", pc, pw, arena_from_reference(ra, "cpu"),
                           cfgs[1], plan=plan_from_reference(want_s.plan),
                           packed=False)
    return dict(want=want_s, got=got_s, wl=wl, world=world, pw=pw, pc=pc,
                corpus=corpus, ra=ra, cfgs=cfgs)


def test_hybrid_searcher_matches_reference(hybrid):
    """Hybrid AnonySys at ~20k rows: the same graph and flat partitions,
    probe parameters and batcher slabs; ids equal (ties as sets), every
    row readable by its user."""
    want_s, got_s, wl = hybrid["want"], hybrid["got"], hybrid["wl"]
    kinds = lambda s: {pid: type(p.index).__name__
                       for pid, p in s.partitions.items()}
    gk, wk = kinds(got_s), kinds(want_s)
    assert {p: k.replace("Int8Flat", "X") for p, k in gk.items()} == \
        {p: k.replace("Int8Flat", "X") for p, k in wk.items()}
    n_graph = sum(k == "HNSWIndex" for k in gk.values())
    assert n_graph >= 10 and n_graph < len(gk)
    assert isinstance(got_s.graph_batcher, GraphProbeBatcher)
    assert got_s.graph_batcher.slot_of == want_s.graph_batcher.slot_of
    for uid in np.unique(wl.user_ids)[:20]:
        for pid in got_s.router(int(uid)):
            assert got_s.probe_params(int(uid), pid) == \
                want_s.probe_params(int(uid), pid)
    want = want_s.search_batch(wl.vectors, wl.user_ids,
                               hybrid["world"].user_masks, 10)
    got = got_s.search_batch(wl.vectors, wl.user_ids, hybrid["pw"].user_masks,
                             10)
    (gd, gi), (wd, wi) = got, want
    np.testing.assert_array_equal(gd, wd)
    for q in range(len(gi)):
        for v in np.unique(wd[q]):
            assert set(gi[q][gd[q] == v]) == set(wi[q][wd[q] == v]), (q, v)
    assert (gi >= 0).mean() > 0.9
    bits = hybrid["pc"].vector_role_bits(hybrid["pw"])
    masks = hybrid["pw"].user_masks[wl.user_ids]
    readable = (bits[np.maximum(gi, 0)] & masks[:, None, :]).any(-1)
    assert (readable | (gi < 0)).all()


def test_hybrid_storage_counts_the_batcher(hybrid):
    """The hybrid's storage report counts the graph batcher's slabs (graph
    and row map) and its packed rows, on top of the arena and the
    partitions (the reference leaves both out)."""
    got_s = hybrid["got"]
    b = got_s.graph_batcher
    rep = got_s.storage_report()
    mb = 1024 * 1024
    slabs = sum(g3.numel() * 4 + rm2.numel() * 4
                for g3, rm2 in b.slabs.values())
    a = got_s.arena
    packed = a.n_padded * (a.quant.d_pad + 4 * a.role_bits.shape[1] + 4)
    assert slabs > 0 and rep["graph_slab_mb"] == slabs / mb
    assert rep["packed_rows_mb"] == packed / mb
    if b._packed is not None:
        assert b._packed.numel() == packed
    parts = sum(rep[k] for k in ("arena_vectors_mb", "arena_aux_mb",
                                 "partition_vectors_mb",
                                 "partition_index_mb"))
    assert rep["total_mb"] == pytest.approx(parts + (slabs + packed) / mb)


def test_dynamic_hnsw_matches_reference_at_top100(hybrid):
    """AnonySys with an HNSW graph on every partition (the bench's
    `--strategy dynamic --index hnsw`) at top-100, on the hybrid plan: the
    port returns the reference's distances and ids (ties as sets), so its
    recall is the reference's. Recall is split by whether a query's user
    routes to the remainder (the largest partition, a few percent of whose
    rows the user can read): the filtered graph search there is what
    loses recall, in both packages."""
    k = 100
    ref_cfg, port_cfg = (copy.deepcopy(c) for c in hybrid["cfgs"])
    ref_cfg.index.kind = port_cfg.index.kind = "hnsw"
    want_s = ref_searcher("dynamic", hybrid["corpus"], hybrid["world"],
                          hybrid["ra"], ref_cfg, packed=False)
    got_s = build_searcher("dynamic", hybrid["pc"], hybrid["pw"],
                           arena_from_reference(hybrid["ra"], "cpu"),
                           port_cfg, plan=plan_from_reference(want_s.plan),
                           packed=False)
    assert all(type(p.index).__name__ == "HNSWIndex"
               for p in got_s.partitions.values())
    wl, pw, pc = hybrid["wl"], hybrid["pw"], hybrid["pc"]
    wd, wi = want_s.search_batch(wl.vectors, wl.user_ids,
                                 hybrid["world"].user_masks, k)
    gd, gi = got_s.search_batch(wl.vectors, wl.user_ids, pw.user_masks, k)
    np.testing.assert_array_equal(gd, wd)
    for q in range(len(gi)):
        for v in np.unique(wd[q]):
            assert set(gi[q][gd[q] == v]) == set(wi[q][wd[q] == v]), (q, v)
    bits = pc.vector_role_bits(pw)
    masks = pw.user_masks[wl.user_ids]
    readable = (bits[np.maximum(gi, 0)] & masks[:, None, :]).any(-1)
    assert (readable | (gi < 0)).all()
    vec = pc.vectors.astype(np.float32)
    recall = np.empty(len(gi))
    for q in range(len(gi)):
        dist = ((vec - wl.vectors[q]) ** 2).sum(1)
        dist[~(bits & masks[q]).any(-1)] = np.inf
        truth = np.argsort(dist, kind="stable")[:k]
        truth = set(truth[np.isfinite(dist[truth])])
        recall[q] = len(truth & set(gi[q][gi[q] >= 0])) / len(truth)
    big = max(got_s.partitions, key=lambda p: len(got_s.partitions[p].rows))
    routed = np.array([big in got_s.router(int(u)) for u in wl.user_ids])
    rows = got_s.partitions[big].rows
    sel = (bits[rows][None] & masks[routed][:, None, :]).any(-1).mean(1)
    print(f"dynamic hnsw top-{k}: recall {recall.mean()}, "
          f"{routed.mean()} of the queries routed to the remainder "
          f"({len(rows)} of {pc.n} rows, {sel.mean()} of them readable by "
          f"the user on average): recall {recall[routed].mean()} there, "
          f"{recall[~routed].mean()} elsewhere")
    assert routed.any() and (~routed).any()
    assert recall[routed].mean() < recall[~routed].mean()
