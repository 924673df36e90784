"""The sparse corpus (pgvector's sparsevec).

A copy of vectorsearch_rbac_tpu/data/sparse.py `SparseCorpus` and
`synthetic_sparse_corpus`; tests/test_torch_host.py holds the arrays equal
to the reference's for the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..rbac import RBACWorld


@dataclass(frozen=True)
class SparseCorpus:
    """CSR sparse corpus (pgvector's sparsevec) with the (doc, block)
    identity columns of Corpus, so that the RBAC layer applies unchanged."""

    indptr: np.ndarray     # (N+1,) int64 row pointers
    indices: np.ndarray    # (nnz,) int32 column ids, sorted within a row
    data: np.ndarray       # (nnz,) float32 values (non-zero)
    dim: int
    doc_ids: np.ndarray    # (N,) int32
    block_ids: np.ndarray  # (N,) int32

    def __post_init__(self):
        if self.indptr.ndim != 1 or self.indptr[0] != 0 \
                or self.indices.shape != self.data.shape \
                or self.doc_ids.shape != (self.n,):
            raise ValueError("SparseCorpus takes CSR arrays and (N,) id "
                             "columns")

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @cached_property
    def num_docs(self) -> int:
        return int(self.doc_ids.max()) + 1 if self.n else 0

    @cached_property
    def norms(self) -> np.ndarray:
        """(N,) float64 squared L2 norms."""
        out = np.zeros(self.n, dtype=np.float64)
        sq = self.data.astype(np.float64) ** 2
        np.add.at(out, np.repeat(np.arange(self.n),
                                 np.diff(self.indptr)), sq)
        return out

    def row_dense(self, i: int) -> np.ndarray:
        """One row densified."""
        out = np.zeros(self.dim, dtype=np.float32)
        s, e = self.indptr[i], self.indptr[i + 1]
        out[self.indices[s:e]] = self.data[s:e]
        return out

    def vector_role_bits(self, world: RBACWorld) -> np.ndarray:
        return world.doc_role_bits[self.doc_ids]


def synthetic_sparse_corpus(num_docs: int, blocks_per_doc: int = 4,
                            dim: int = 4096, nnz_low: int = 16,
                            nnz_high: int = 48, num_topics: int = 32,
                            seed: int = 0) -> SparseCorpus:
    """Clustered synthetic sparse corpus: each document draws a topic, a
    topic owns a column subset, and 80% of a row's support comes from its
    topic's columns (rows of one topic share support, as learned-sparse
    encoders' do)."""
    rng = np.random.default_rng(seed)
    n = num_docs * blocks_per_doc
    topic_of_doc = rng.integers(0, num_topics, num_docs)
    topic_cols = [rng.choice(dim, size=min(dim, 4 * nnz_high), replace=False)
                  for _ in range(num_topics)]
    indptr = [0]
    indices = []
    data = []
    doc_ids = np.repeat(np.arange(num_docs, dtype=np.int32), blocks_per_doc)
    block_ids = np.tile(np.arange(blocks_per_doc, dtype=np.int32), num_docs)
    for i in range(n):
        t = topic_of_doc[doc_ids[i]]
        nnz = int(rng.integers(nnz_low, min(nnz_high, dim) + 1))
        n_topic = min(max(1, int(0.8 * nnz)), len(topic_cols[t]))
        cols = np.concatenate([
            rng.choice(topic_cols[t], size=n_topic, replace=False),
            rng.choice(dim, size=nnz - n_topic, replace=False),
        ])
        cols = np.unique(cols)
        vals = np.abs(rng.standard_normal(len(cols))).astype(np.float32) + 0.05
        indices.append(cols.astype(np.int32))
        data.append(vals)
        indptr.append(indptr[-1] + len(cols))
    return SparseCorpus(
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=np.concatenate(indices) if indices else np.empty(0, np.int32),
        data=np.concatenate(data) if data else np.empty(0, np.float32),
        dim=dim, doc_ids=doc_ids, block_ids=block_ids)
