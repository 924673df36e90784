"""The seeded corpora: the SIFT-like, cohere-like and float synthetic
twins, and the sparse corpus.

A copy of vectorsearch_rbac_tpu/data/datasets.py `synthetic_corpus`,
`sift_like_corpus`, `cohere_like_corpus` and the SIFT, cohere/wikipedia
and synthetic branches of `resolve_dataset`, and of data/sparse.py
(`SparseCorpus`, `synthetic_sparse_corpus`), so that the port runs where
the JAX package is absent; tests/test_torch_host.py holds the arrays equal
to the reference's for the same seed. Dataset files (SIFT HDF5/.mat,
embedding dumps) are not read: the reference also falls back to these
twins when no file is present.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

import numpy as np

from .core import Corpus
from .rbac import RBACWorld

# the reference groups 100 SIFT vectors into one synthetic document
SIFT_DOCUMENT_VECTOR_COUNT = 100


def _group_into_documents(vectors: np.ndarray, blocks_per_doc: int) -> Corpus:
    """Consecutive vectors form documents of blocks_per_doc blocks; rows are
    then ordered block-major (every document's block 0, then block 1, ...),
    so a document's blocks spread across the row space. Permissions are
    per document: without the spread, admissible rows form dense runs and
    the group-minimum scan loses far more of the top-k to same-group
    collisions."""
    n = vectors.shape[0]
    doc_ids = (np.arange(n) // blocks_per_doc).astype(np.int32)
    block_ids = (np.arange(n) % blocks_per_doc).astype(np.int32)
    if blocks_per_doc > 1:
        perm = np.argsort(block_ids, kind="stable")
        vectors, doc_ids, block_ids = (vectors[perm], doc_ids[perm],
                                       block_ids[perm])
    return Corpus(vectors=np.ascontiguousarray(vectors, dtype=np.float32),
                  doc_ids=np.ascontiguousarray(doc_ids),
                  block_ids=np.ascontiguousarray(block_ids))


def synthetic_corpus(num_docs: int, blocks_per_doc: int = 1, dim: int = 128,
                     seed: int = 0, distribution: str = "normal") -> Corpus:
    """num_docs * blocks_per_doc standard-normal (or uniform [0, 1))
    float32 vectors."""
    rng = np.random.default_rng(seed)
    n = num_docs * blocks_per_doc
    if distribution == "normal":
        vecs = rng.standard_normal((n, dim), dtype=np.float32)
    elif distribution == "uniform":
        vecs = rng.random((n, dim), dtype=np.float32)
    else:
        raise ValueError(f"unknown distribution {distribution}")
    return _group_into_documents(vecs, blocks_per_doc)


def sift_like_corpus(num_vectors: int = 1_000_000, dim: int = 128,
                     blocks_per_doc: int = SIFT_DOCUMENT_VECTOR_COUNT,
                     seed: int = 0) -> Tuple[Corpus, np.ndarray]:
    """SIFT-shaped synthetic data: integer features in [0, 255] drawn from
    a clustered mixture (real SIFT has a low intrinsic dimension). Returns
    (corpus, query_pool), the pool being 10k held-out vectors."""
    rng = np.random.default_rng(seed)
    total = num_vectors + 10_000
    n_centers = max(64, min(4096, total // 500))
    centers = rng.gamma(shape=1.2, scale=40.0,
                        size=(n_centers, dim)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=total)
    noise = rng.standard_normal((total, dim)).astype(np.float32) * 18.0
    vecs = np.clip(np.floor(centers[assign] + noise), 0, 255).astype(
        np.float32)
    return (_group_into_documents(vecs[:num_vectors], blocks_per_doc),
            vecs[num_vectors:])


def cohere_like_corpus(num_vectors: int = 1_000_000, dim: int = 768,
                       blocks_per_doc: int = SIFT_DOCUMENT_VECTOR_COUNT,
                       seed: int = 0) -> Tuple[Corpus, np.ndarray]:
    """Cohere wikipedia-22-12-shaped synthetic data: unit-normalized dense
    embeddings (768-d). Returns (corpus, query_pool), the pool being 10k
    held-out vectors (a copy, so the full draw can be freed)."""
    rng = np.random.default_rng(seed)
    total = num_vectors + 10_000
    vecs = rng.standard_normal((total, dim), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    corpus = _group_into_documents(vecs[:num_vectors], blocks_per_doc)
    return corpus, vecs[num_vectors:].copy()


def resolve_dataset(name: str, num_vectors: int = 1_000_000,
                    seed: int = 0) -> Tuple[Corpus, np.ndarray]:
    """(corpus, query_pool) for a dataset name, as the reference resolves it
    when no dataset file is given: "sift", "sift1m" and "sift10m" give the
    SIFT-like twin, "cohere" and "wikipedia" the cohere-like one, and
    "synthetic" standard-normal rows in documents of 100 with a pool of
    10,000 standard-normal queries drawn from seed + 1."""
    if name in ("sift", "sift1m", "sift10m"):
        return sift_like_corpus(num_vectors=num_vectors, seed=seed)
    if name in ("cohere", "wikipedia"):
        return cohere_like_corpus(num_vectors=num_vectors, seed=seed)
    if name == "synthetic":
        corpus = synthetic_corpus(
            num_docs=num_vectors // SIFT_DOCUMENT_VECTOR_COUNT,
            blocks_per_doc=SIFT_DOCUMENT_VECTOR_COUNT, seed=seed)
        rng = np.random.default_rng(seed + 1)
        return corpus, rng.standard_normal((10_000, corpus.dim)).astype(
            np.float32)
    raise NotImplementedError(
        f"dataset {name!r}: the port resolves only the seeded twins; "
        "dataset files are not read (ROADMAP queue 1 item 17)")


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
