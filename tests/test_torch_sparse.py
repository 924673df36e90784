"""The port's sparse index against the JAX reference on the CPU: the padded
CSR layout, query densification, and SparseFlatIndex in all four metrics
(sparse and dense queries, a row subset, the gather cut into row chunks).

Both packages build the world (32 roles) and the sparse corpus from the
same seeds with their own code. Tolerances: the padded layout and dense
queries are identical; distances within rtol 1e-5 of the case's largest
(float32 summation order), ids equal except among distances within that
tolerance, compared as sets.
"""

import numpy as np
import pytest

import vectorsearch_rbac_tpu_torch as port
from test_torch_packed import assert_same_topk
from vectorsearch_rbac_tpu.data.sparse import (
    synthetic_sparse_corpus as ref_sparse_corpus)
from vectorsearch_rbac_tpu.index.sparse import (
    SparseFlatIndex as RefSparseIndex)
from vectorsearch_rbac_tpu.ops.sparse_scan import (
    densify_queries as ref_densify)
from vectorsearch_rbac_tpu.ops.sparse_scan import (
    pad_sparse_rows as ref_pad_rows)
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu_torch.data import synthetic_sparse_corpus
from vectorsearch_rbac_tpu_torch.index.sparse import SparseFlatIndex
from vectorsearch_rbac_tpu_torch.ops import sparse_scan
from vectorsearch_rbac_tpu_torch.ops.sparse_scan import (densify_queries,
                                                         pad_sparse_rows)

WORLD = dict(num_users=60, num_roles=32, num_docs=150, h=3, b0=2, b1=3,
             seed=13)
CORPUS = dict(num_docs=150, blocks_per_doc=4, dim=512, nnz_low=8,
              nnz_high=24, num_topics=8, seed=14)
NQ, K, BLOCK = 16, 8, 128
METRICS = ["l2", "ip", "cosine", "l1"]


def _sparse_queries(corpus, nq, seed):
    """Perturbed corpus rows, 32 columns padded with `dim`."""
    rng = np.random.default_rng(seed)
    q_cols = np.full((nq, 32), corpus.dim, np.int32)
    q_vals = np.zeros((nq, 32), np.float32)
    for i, r in enumerate(rng.integers(0, corpus.n, nq)):
        s, e = corpus.indptr[r], corpus.indptr[r + 1]
        take = min(e - s, 32)
        q_cols[i, :take] = corpus.indices[s:s + take]
        q_vals[i, :take] = corpus.data[s:s + take] * (
            1.0 + 0.1 * rng.standard_normal(take)).astype(np.float32)
    return q_cols, q_vals


@pytest.fixture(scope="module")
def worlds():
    rw = RefTreeGenerator(**WORLD).generate()
    rc = ref_sparse_corpus(**CORPUS)
    q_cols, q_vals = _sparse_queries(rc, NQ, seed=15)
    users = np.random.default_rng(16).integers(0, rw.num_users, NQ)
    return dict(rw=rw, rc=rc, pw=port.TreeRBACGenerator(**WORLD).generate(),
                pc=synthetic_sparse_corpus(**CORPUS), q_cols=q_cols,
                q_vals=q_vals, users=users, masks=rw.user_masks[users])


def test_pad_rows_and_densify_identical(worlds):
    """The padded CSR block layout (pad column `dim`, zero values, rows
    past n all pads) and the dense query buffers equal the reference's."""
    c = worlds["rc"]
    for nnz_pad in (None, 32):
        got = pad_sparse_rows(c.indptr, c.indices, c.data, c.dim, 640,
                              nnz_pad)
        want = ref_pad_rows(c.indptr, c.indices, c.data, c.dim, 640,
                            nnz_pad)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pad_sparse_rows(c.indptr, c.indices, c.data, c.dim, 640, 8)
    np.testing.assert_array_equal(
        densify_queries(worlds["q_cols"], worlds["q_vals"], c.dim),
        ref_densify(worlds["q_cols"], worlds["q_vals"], c.dim))


@pytest.mark.parametrize("metric", METRICS)
def test_sparse_index_matches_reference(worlds, metric):
    """Sparse queries over the whole corpus and over a row subset (ids
    back through the row map): the reference's distances and ids; storage
    counted alike."""
    w = worlds
    for rows in (None, np.arange(1, w["rc"].n, 2)):
        want_ix = RefSparseIndex(w["rc"], w["rw"], rows, block_rows=BLOCK,
                                 query_batch=8, metric=metric)
        got_ix = SparseFlatIndex(w["pc"], w["pw"], rows, device="cpu",
                                 block_rows=BLOCK, query_batch=8,
                                 metric=metric)
        want = want_ix.search_sparse(w["q_cols"], w["q_vals"], w["masks"],
                                     K)
        got = got_ix.search_sparse(w["q_cols"], w["q_vals"], w["masks"], K)
        assert_same_topk(got, want)
        assert (got[1] >= 0).sum() > 0.5 * got[1].size
        if rows is not None:
            assert set(got[1][got[1] >= 0]) <= set(rows)
        assert got_ix.storage_bytes() == want_ix.storage_bytes()


@pytest.mark.parametrize("metric", METRICS)
def test_sparse_scan_against_dense_numpy(worlds, metric, monkeypatch):
    """The dense-query entry, the gather cut into 16-row chunks, against a
    float64 recomputation over the densified rows: the same top-k, every
    row readable by its user."""
    monkeypatch.setattr(sparse_scan, "_GATHER_BYTES",
                        16 * 4 * NQ * 24)
    w = worlds
    c = w["pc"]
    qd = densify_queries(w["q_cols"], w["q_vals"], c.dim)[:, :-1]
    d, i = SparseFlatIndex(c, w["pw"], device="cpu", block_rows=BLOCK,
                           metric=metric).search(qd, w["masks"], K)
    dense = np.stack([c.row_dense(r) for r in range(c.n)]).astype(np.float64)
    bits = c.vector_role_bits(w["pw"])
    ok = (bits[:, None, :] & w["masks"][None]).any(axis=2)
    for qi in range(NQ):
        q = qd[qi].astype(np.float64)
        if metric == "l2":
            dist = ((dense - q) ** 2).sum(axis=1)
        elif metric == "l1":
            dist = np.abs(dense - q).sum(axis=1)
        elif metric == "ip":
            dist = -(dense @ q)
        else:
            un = dense / np.linalg.norm(dense, axis=1, keepdims=True)
            dist = 1.0 - un @ (q / np.linalg.norm(q))
        dist[~ok[:, qi]] = np.inf
        want = np.sort(dist)[:K]
        fin = np.isfinite(want)
        np.testing.assert_allclose(d[qi][fin], want[fin], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[fin]).max())
        assert (i[qi][fin] >= 0).all() and (i[qi][~fin] == -1).all()
        assert ok[i[qi][fin], qi].all()


def test_sparse_zero_role_user_gets_nothing(worlds):
    """A user with no role gets +inf / -1 in every slot."""
    w = worlds
    masks = w["masks"].copy()
    masks[:] = 0
    d, i = SparseFlatIndex(w["pc"], w["pw"], device="cpu",
                           block_rows=BLOCK).search_sparse(
        w["q_cols"], w["q_vals"], masks, K)
    assert np.isinf(d).all() and (i == -1).all()
