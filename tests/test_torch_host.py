"""The port's host layer (config, rbac, data, the host half of core)
against the reference's, which it copies so that the port runs without
the JAX package: the same seeds must give the same arrays, mappings and
quantization, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu import core as ref_core
from vectorsearch_rbac_tpu.data import cohere_like_corpus as ref_cohere_like
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_sift_like
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.rbac.world import (
    query_masks_for as ref_query_masks_for)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import core, rbac
from vectorsearch_rbac_tpu_torch.ops.rerank import rebuild_query


@pytest.mark.parametrize("n,seed", [(12_000, 0), (3_000, 7)])
def test_sift_like_corpus_identical(n, seed):
    want, want_pool = ref_sift_like(num_vectors=n, seed=seed)
    got, got_pool = port.sift_like_corpus(num_vectors=n, seed=seed)
    for field in ("vectors", "doc_ids", "block_ids"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert np.array_equal(got_pool, want_pool)
    assert got.num_docs == want.num_docs
    np.testing.assert_array_equal(got.doc_row_offsets, want.doc_row_offsets)


@pytest.mark.parametrize("params", [
    dict(num_users=10_000, num_roles=100, num_docs=10_000, h=4, b0=3, b1=4,
         seed=0),                                # bench.py's world
    dict(num_users=400, num_roles=40, num_docs=163, h=3, b0=3, b1=3, seed=5),
    dict(num_users=50, num_roles=70, num_docs=90, h=2, b0=2, b1=2, seed=1),
], ids=["bench", "small", "overflow-roles"])
def test_tree_world_identical(params):
    want = RefTreeGenerator(**params).generate()
    got = port.TreeRBACGenerator(**params).generate()
    assert dict(got.user_to_roles) == dict(want.user_to_roles)
    assert dict(got.role_to_docs) == dict(want.role_to_docs)
    assert got.words == want.words and got.combs == want.combs
    np.testing.assert_array_equal(got.user_masks, want.user_masks)
    np.testing.assert_array_equal(got.doc_role_bits, want.doc_role_bits)
    for u in (0, params["num_users"] // 2, params["num_users"] - 1):
        assert got.user_docs(u) == want.user_docs(u)


@pytest.mark.parametrize("params", [
    dict(num_users=400, num_roles=40, num_docs=163, h=3, b0=3, b1=3, seed=5),
    dict(num_users=50, num_roles=70, num_docs=90, h=2, b0=2, b1=2, seed=1),
], ids=["small", "overflow-roles"])
def test_world_role_insert_and_delete_identical(params):
    """with_new_role (the new role's id, documents and users) and
    without_role (role ids not renumbered, the role gone from every user)
    give the reference's worlds: mappings, masks, bits and combs."""
    want = RefTreeGenerator(**params).generate()
    got = port.TreeRBACGenerator(**params).generate()
    users = [0, 3, params["num_users"] - 1]
    docs = range(0, params["num_docs"], 7)
    got2, r = got.with_new_role(docs, users=users)
    want2, want_r = want.with_new_role(docs, users=users)
    assert r == want_r == params["num_roles"]
    victim = got.user_to_roles[0][0]
    pairs = [(got2, want2), (got.without_role(victim),
                             want.without_role(victim)),
             (got2.without_role(r), want2.without_role(r))]
    for g, w in pairs:
        assert (g.num_roles, g.num_users, g.num_docs) == (
            w.num_roles, w.num_users, w.num_docs)
        assert dict(g.user_to_roles) == dict(w.user_to_roles)
        assert dict(g.role_to_docs) == dict(w.role_to_docs)
        assert g.words == w.words and g.combs == w.combs
        np.testing.assert_array_equal(g.user_masks, w.user_masks)
        np.testing.assert_array_equal(g.doc_role_bits, w.doc_role_bits)
    assert got2.words == (params["num_roles"] + 32) // 32
    assert all(victim not in rs for rs in pairs[1][0].user_to_roles.values())
    assert pairs[1][0].num_roles == params["num_roles"]


def test_tree_generator_refuses_too_few_docs():
    with pytest.raises(ValueError, match="one document per role"):
        port.TreeRBACGenerator(num_roles=10, num_docs=5)


def test_vector_role_bits_and_query_masks():
    corpus, _ = port.sift_like_corpus(num_vectors=2_000, seed=1)
    params = dict(num_users=30, num_roles=12, num_docs=corpus.num_docs,
                  seed=2)
    got_w = port.TreeRBACGenerator(**params).generate()
    want_w = RefTreeGenerator(**params).generate()
    want_c, _ = ref_sift_like(num_vectors=2_000, seed=1)
    np.testing.assert_array_equal(corpus.vector_role_bits(got_w),
                                  want_c.vector_role_bits(want_w))
    users = np.array([0, 29, 3, 3])
    np.testing.assert_array_equal(
        rbac.query_masks_for(got_w.user_masks, users),
        ref_query_masks_for(want_w.user_masks, users))
    with pytest.raises(ValueError, match="out of range"):
        rbac.query_masks_for(got_w.user_masks, np.array([30]))


@pytest.mark.parametrize("kind", ["sift", "gaussian", "wide"])
def test_quantization_identical(kind):
    rng = np.random.default_rng(4)
    if kind == "sift":
        x = rng.integers(0, 256, size=(500, 128)).astype(np.float32)
    else:
        x = rng.standard_normal((500, 768 if kind == "wide" else 100),
                                dtype=np.float32)
    q = x[:40] + rng.standard_normal((40, x.shape[1]), dtype=np.float32)
    npad = core.pad_rows(500, 256)
    want = ref_core.quantize_corpus(x, npad)
    got = core.quantize_corpus(x, npad)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    xq, nq, scale, center, lossless, qclip = got
    assert lossless == (kind == "sift")
    mine = core.ArenaQuant(vectors_q=xq, norms_q=nq, scale=scale,
                           center=center, lossless=lossless, qclip=qclip)
    ref = ref_core.ArenaQuant(vectors_q=xq, norms_q=nq, roles8=None,
                              scale=scale, center=center, lossless=lossless,
                              qclip=qclip)
    assert mine.score_shift == ref.score_shift
    for with_norms in (True, False):
        for a, b in zip(mine.quantize_queries(q, with_norms),
                        ref.quantize_queries(q, with_norms)):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,dim,seed", [(3_000, 768, 0), (1_000, 384, 3)])
def test_cohere_like_corpus_identical(n, dim, seed):
    want, want_pool = ref_cohere_like(num_vectors=n, dim=dim, seed=seed)
    got, got_pool = port.cohere_like_corpus(num_vectors=n, dim=dim,
                                            seed=seed)
    for field in ("vectors", "doc_ids", "block_ids"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got_pool.dtype == want_pool.dtype
    assert np.array_equal(got_pool, want_pool)


def _quant_pair(x):
    xq, nq, scale, center, lossless, qclip = core.quantize_corpus(
        x, core.pad_rows(len(x), 256))
    mine = core.ArenaQuant(vectors_q=xq, norms_q=nq, scale=scale,
                           center=center, lossless=lossless, qclip=qclip)
    ref = ref_core.ArenaQuant(vectors_q=xq, norms_q=nq, roles8=None,
                              scale=scale, center=center, lossless=lossless,
                              qclip=qclip)
    return mine, ref


@pytest.mark.parametrize("cosine", [False, True])
@pytest.mark.parametrize("dim", [100, 768])
def test_ip_query_quantizers_identical(cosine, dim):
    """quantize_queries_ip and the residual8 / residual4 codes, bit for bit
    (the residual codes of the padding columns included)."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((500, dim), dtype=np.float32)
    q = rng.standard_normal((40, dim), dtype=np.float32) * 3.0
    q[5] = 0.0                                  # a zero query
    mine, ref = _quant_pair(x)
    got, want = (mine.quantize_queries_ip(q, cosine=cosine),
                 ref.quantize_queries_ip(q, cosine=cosine))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    q8, inv, _ = want
    for name in ("query_residual8", "query_residual4"):
        a = getattr(mine, name)(q, q8, inv, cosine=cosine)
        b = getattr(ref, name)(q, q8, inv, cosine=cosine)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    r4 = mine.query_residual4(q, q8, inv, cosine=cosine)
    assert r4.dtype == np.uint8 and r4.shape == (40, q8.shape[1] // 2)


def test_residual4_rebuild_recovers_the_query():
    """The nibble codes rebuild each component of the scaled query to
    within 1/30 of an int8 step (the code's half step), the low nibble
    being the even component: a swapped nibble order fails this."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 130), dtype=np.float32)
    q = rng.standard_normal((12, 130), dtype=np.float32)
    mine, _ = _quant_pair(x)
    q8, inv, _ = mine.quantize_queries_ip(q)
    r4 = mine.query_residual4(q, q8, inv)
    t = torch.from_numpy
    got = rebuild_query("residual4", "ip", 130, t(q8), inv=t(inv),
                        q_dequant=float(np.float32(mine.scale)),
                        residual=t(r4)).numpy()
    qs = 1.0 / (inv * mine.scale)
    err = np.abs(got - q) * qs[:, None]         # in int8 steps
    assert err.max() <= 1 / 30 + 1e-4, err.max()


def test_cosine_arena_identical():
    """The cosine arena's host arrays (rows normalized at ingest, their
    norms, the int8 copy and its scale and center) and its bfloat16 mirror,
    against the reference's build_device_arena."""
    corpus, _ = port.cohere_like_corpus(num_vectors=2_000, dim=384, seed=1)
    corpus = core.Corpus(vectors=corpus.vectors * 3.0, doc_ids=corpus.doc_ids,
                         block_ids=corpus.block_ids)   # not unit rows
    w = port.TreeRBACGenerator(num_users=30, num_roles=12,
                               num_docs=corpus.num_docs, seed=2).generate()
    ref_corpus = ref_core.Corpus(vectors=corpus.vectors,
                                 doc_ids=corpus.doc_ids,
                                 block_ids=corpus.block_ids)
    want = ref_core.build_device_arena(
        ref_corpus, RefTreeGenerator(num_users=30, num_roles=12,
                                     num_docs=corpus.num_docs,
                                     seed=2).generate(),
        block_rows=1024, dtype="int8", metric="cosine")
    got = core.build_device_arena(corpus, w, device="cpu", block_rows=1024,
                                  dtype="int8", metric="cosine")
    assert got.metric == want.metric == "cosine"
    np.testing.assert_array_equal(
        got.vectors.to(torch.float32).numpy(),
        np.asarray(want.vectors).astype(np.float32))
    np.testing.assert_array_equal(got.norms.numpy(), want.host_norms)
    np.testing.assert_array_equal(got.host_bits, want.host_bits)
    np.testing.assert_array_equal(got.quant.vectors_q.numpy(),
                                  want.quant.host_vectors_q)
    np.testing.assert_array_equal(got.quant.norms_q.numpy(),
                                  want.quant.host_norms_q)
    assert got.quant.scale == want.quant.scale
    np.testing.assert_array_equal(got.quant.center, want.quant.center)
    assert not got.quant.lossless and got.quant.score_shift == 2
    mirror = core.arena_from_reference(want, "cpu")
    assert mirror.metric == "cosine"
    assert torch.equal(mirror.vectors, got.vectors)


def test_quantize_corpus_row_chunks_identical(monkeypatch):
    """The port quantizes in row chunks; with chunks that do not divide the
    row count the output still equals the reference's whole-array code."""
    monkeypatch.setattr(core, "_QUANT_ROWS", 97)
    x = np.random.default_rng(6).standard_normal((500, 768),
                                                 dtype=np.float32)
    for a, b in zip(core.quantize_corpus(x, 512),
                    ref_core.quantize_corpus(x, 512)):
        np.testing.assert_array_equal(a, b)


def test_pad_rows_and_score_shift_identical():
    for n in (1, 127, 128, 1_000_000, 1_048_577):
        for m in (128, 8192, 131072):
            assert core.pad_rows(n, m) == ref_core.pad_rows(n, m)
    for d_pad in (128, 256, 384, 768, 1024, 2048):
        for qclip in (60, 127, 128):
            assert (core.score_shift_for(d_pad, qclip)
                    == ref_core.score_shift_for(d_pad, qclip))


def test_config_defaults_match_reference():
    """The port's config carries the reference's fields it reads, with the
    reference's defaults."""
    ref = RefFrameworkConfig()
    mine = port.FrameworkConfig()
    assert mine.seed == ref.seed
    for part in ("search", "index", "optimizer"):
        for f in dataclasses.fields(getattr(mine, part)):
            assert (getattr(getattr(mine, part), f.name)
                    == getattr(getattr(ref, part), f.name)), (part, f.name)


def test_resolve_dataset():
    got, pool = port.resolve_dataset("sift1m", num_vectors=1_000, seed=3)
    want, want_pool = ref_sift_like(num_vectors=1_000, seed=3)
    assert np.array_equal(got.vectors, want.vectors)
    assert np.array_equal(pool, want_pool)
    got, pool = port.resolve_dataset("cohere", num_vectors=1_000, seed=3)
    want, want_pool = ref_cohere_like(num_vectors=1_000, seed=3)
    assert np.array_equal(got.vectors, want.vectors)
    assert np.array_equal(pool, want_pool)
    from vectorsearch_rbac_tpu.data import resolve_dataset as ref_resolve
    got, pool = port.resolve_dataset("synthetic", num_vectors=1_000, seed=3)
    want, want_pool = ref_resolve("synthetic", num_vectors=1_000, seed=3)
    assert np.array_equal(got.vectors, want.vectors)
    assert np.array_equal(got.doc_ids, want.doc_ids)
    assert np.array_equal(pool, want_pool)
    # the reference's refusal of a name it does not know
    with pytest.raises(ValueError, match="unknown dataset arxiv"):
        port.resolve_dataset("arxiv", num_vectors=1_000)
    with pytest.raises(ValueError, match="unknown dataset arxiv"):
        ref_resolve("arxiv", num_vectors=1_000)


@pytest.mark.parametrize("dist", ["normal", "uniform"])
def test_synthetic_corpus_identical(dist):
    from vectorsearch_rbac_tpu.data import synthetic_corpus as ref_synthetic
    from vectorsearch_rbac_tpu_torch.data import synthetic_corpus
    kw = dict(num_docs=30, blocks_per_doc=7, dim=24, seed=5,
              distribution=dist)
    got, want = synthetic_corpus(**kw), ref_synthetic(**kw)
    for f in ("vectors", "doc_ids", "block_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_sparse_corpus_identical():
    """The sparse corpus's CSR arrays, ids, norms, a dense row and its role
    bitsets equal the reference's for the same seeds."""
    from vectorsearch_rbac_tpu.data.sparse import (
        synthetic_sparse_corpus as ref_sparse)
    from vectorsearch_rbac_tpu_torch.data import synthetic_sparse_corpus
    kw = dict(num_docs=40, blocks_per_doc=3, dim=300, nnz_low=5,
              nnz_high=20, num_topics=6, seed=9)
    got, want = synthetic_sparse_corpus(**kw), ref_sparse(**kw)
    for f in ("indptr", "indices", "data", "doc_ids", "block_ids", "norms"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.n, got.dim, got.num_docs) == (want.n, want.dim,
                                              want.num_docs)
    np.testing.assert_array_equal(got.row_dense(7), want.row_dense(7))
    pw = port.TreeRBACGenerator(num_users=20, num_roles=8, num_docs=40,
                                seed=2).generate()
    rw = RefTreeGenerator(num_users=20, num_roles=8, num_docs=40,
                          seed=2).generate()
    np.testing.assert_array_equal(got.vector_role_bits(pw),
                                  want.vector_role_bits(rw))


def test_augment_with_norms_identical():
    """The augmented layout [x | norm_hi | norm_lo | 0-pad to 8] and the
    l2 query side [-2q | 1 | 1 | 0] equal the reference's on a seed; ip's
    query side zeroes the norm columns."""
    rng = np.random.default_rng(12)
    for d in (5, 32, 126):
        x = (rng.standard_normal((50, d)) * 40).astype(np.float32)
        nrm = np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(
            np.float32)
        got = core.augment_with_norms(torch.from_numpy(x),
                                      torch.from_numpy(nrm))
        np.testing.assert_array_equal(got.numpy(),
                                      ref_core.augment_with_norms(x, nrm))
        q = rng.standard_normal((9, d)).astype(np.float32)
        d_aug = got.shape[1]
        np.testing.assert_array_equal(
            core.augment_queries(torch.from_numpy(q), d_aug).numpy(),
            ref_core.augment_queries(q, d_aug))
        ip = core.augment_queries(torch.from_numpy(q), d_aug, "ip").numpy()
        np.testing.assert_array_equal(ip[:, :d], -q)
        assert not ip[:, d:].any()


# ---- the planner's host layer: world and corpus helpers, cost model,
# optimizer, refinement, weights


def test_world_comb_helpers_identical():
    params = dict(num_users=400, num_roles=40, num_docs=163, h=3, b0=3,
                  b1=3, seed=5)
    want = RefTreeGenerator(**params).generate()
    got = port.TreeRBACGenerator(**params).generate()
    assert got.comb_user_counts == want.comb_user_counts
    assert got.comb_weights == want.comb_weights
    for comb in got.combs[:10] + [(0, 3, 7), ()]:
        assert got.comb_docs(comb) == want.comb_docs(comb)
    for r in (0, 17, 39):
        assert got.role_selectivity(r) == want.role_selectivity(r)
    for u in (0, 200, 399):
        assert got.user_selectivity(u) == want.user_selectivity(u)
    assert got.average_role_selectivity() == want.average_role_selectivity()
    assert got.average_user_selectivity() == want.average_user_selectivity()
    assert got.storage_ratio() == want.storage_ratio()


def test_corpus_row_helpers_identical():
    got, _ = port.sift_like_corpus(num_vectors=3_000, blocks_per_doc=7,
                                   seed=2)
    want, _ = ref_sift_like(num_vectors=3_000, blocks_per_doc=7, seed=2)
    assert got.avg_blocks_per_doc == want.avg_blocks_per_doc
    np.testing.assert_array_equal(got.doc_row_index, want.doc_row_index)
    for docs in ([], [0], [5, 2, 400, 3], np.arange(0, want.num_docs, 3)):
        a, b = got.rows_for_docs(docs), want.rows_for_docs(docs)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cost_models_identical():
    from vectorsearch_rbac_tpu.models import cost as ref_cost
    from vectorsearch_rbac_tpu_torch.models import cost

    for name in ("CostModelParams", "TPUCostParams", "IVFCoverageParams"):
        a, b = getattr(cost, name)(), getattr(ref_cost, name)()
        assert a.to_dict() == b.to_dict(), name
        for target in (None, 0.5, 0.9, 0.99):
            for sel in (0.01, 0.2, 1.0):
                for n in (0.0, 5e4, 1e6):
                    assert (cost.model_ef_for_recall(a, target, 10, sel, n)
                            == ref_cost.model_ef_for_recall(b, target, 10,
                                                            sel, n))
        for n_rows in (1, 100, 1e6):
            for ef in (10.0, 300.0):
                assert (cost.model_partition_time(a, n_rows, ef)
                        == ref_cost.model_partition_time(b, n_rows, ef))
    p = cost.CostModelParams(ef_offset=-5.0, n_ref=1e5, gamma_n=0.3)
    q = ref_cost.CostModelParams(ef_offset=-5.0, n_ref=1e5, gamma_n=0.3)
    for ef in (5.0, 50.0, 500.0):
        assert (cost.RecallModel(p).recall(ef, 10, 0.1, 2e5)
                == ref_cost.RecallModel(q).recall(ef, 10, 0.1, 2e5))
    assert (cost.QueryTimeModel(p).query_time([10.0, 1e4], 40.0)
            == ref_cost.QueryTimeModel(q).query_time([10.0, 1e4], 40.0))


def _ref_random_world():
    from vectorsearch_rbac_tpu.rbac.generators import RandomRBACGenerator

    return RandomRBACGenerator(num_users=60, num_roles=10, num_docs=120,
                               m_roles=3, m_perms=30, seed=3).generate()


@pytest.mark.parametrize("world_kind,alpha", [
    ("tree", 2.0), ("tree", 1.2), ("random", 2.5), ("random", 1.5)])
def test_planner_identical(world_kind, alpha):
    """The copied planner (greedy split, both stages, heavy-partition
    refinement, renumbering, coverage) gives the reference's plan: the
    same assignment, trackers and split log. The random world has
    multi-role users, whose combs reach the planner's stage 2."""
    from vectorsearch_rbac_tpu.core import Corpus as RefCorpus
    from vectorsearch_rbac_tpu.partition.dynamic import (
        plan_dynamic_partitions as ref_plan)
    from vectorsearch_rbac_tpu.partition.dynamic.materialize import (
        PlannerInputs as RefInputs)
    from vectorsearch_rbac_tpu.models.cost import (
        CostModelParams as RefParams)
    from vectorsearch_rbac_tpu_torch.partition.dynamic import (
        plan_dynamic_partitions, planner_inputs)

    if world_kind == "tree":
        world = RefTreeGenerator(num_users=300, num_roles=30, num_docs=200,
                                 h=3, b0=2, b1=3, seed=7).generate()
    else:
        world = _ref_random_world()
    corpus = RefCorpus(vectors=np.zeros((world.num_docs * 3, 2), np.float32),
                       doc_ids=np.repeat(np.arange(world.num_docs),
                                         3).astype(np.int32),
                       block_ids=np.tile(np.arange(3), world.num_docs
                                         ).astype(np.int32))
    cfg = port.FrameworkConfig()
    cfg.optimizer.storage_alpha = alpha
    mine = planner_inputs(corpus, world, cfg)
    want_inputs = RefInputs(
        role_to_docs=world.role_to_docs, combs=world.combs,
        comb_weights=world.comb_weights,
        single_role_weights={r: 1.0 / world.num_roles
                             for r in range(world.num_roles)},
        params=RefParams(), alpha=alpha, topk=10,
        avg_blocks_per_doc=corpus.avg_blocks_per_doc)
    got = plan_dynamic_partitions(world, mine)
    want = ref_plan(world, want_inputs)
    assert got.assignment == want.assignment
    assert got.trackers == want.trackers
    assert got.split_log == want.split_log
    assert len(got.assignment) > 1


def test_workload_weights_identical():
    from vectorsearch_rbac_tpu.bench.queries import (
        generate_query_workload as ref_workload)
    from vectorsearch_rbac_tpu.partition.dynamic import weights as ref_w
    from vectorsearch_rbac_tpu_torch.partition.dynamic import weights

    world = _ref_random_world()
    corpus, _ = ref_sift_like(num_vectors=360, blocks_per_doc=3, dim=8,
                              seed=1)
    wl = ref_workload(corpus, world, num_queries=50, topk=5, zipf_param=0,
                      seed=2)
    assert (weights.comb_weights_from_workload(world, wl)
            == ref_w.comb_weights_from_workload(world, wl))
    assert (weights.single_role_weights_from_workload(world, wl)
            == ref_w.single_role_weights_from_workload(world, wl))
