"""The port's host layer (config, rbac, data, the host half of core)
against the reference's, which it copies so that the port runs without
the JAX package: the same seeds must give the same arrays, mappings and
quantization, bit for bit."""

import dataclasses

import numpy as np
import pytest

import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu import core as ref_core
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_sift_like
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.rbac.world import (
    query_masks_for as ref_query_masks_for)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import core, rbac


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
    for part in ("search", "index"):
        for f in dataclasses.fields(getattr(mine, part)):
            assert (getattr(getattr(mine, part), f.name)
                    == getattr(getattr(ref, part), f.name)), (part, f.name)


def test_resolve_dataset():
    got, pool = port.resolve_dataset("sift1m", num_vectors=1_000, seed=3)
    want, want_pool = ref_sift_like(num_vectors=1_000, seed=3)
    assert np.array_equal(got.vectors, want.vectors)
    assert np.array_equal(pool, want_pool)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.resolve_dataset("cohere", num_vectors=1_000)
