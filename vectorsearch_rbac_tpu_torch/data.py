"""The main path's corpus: the seeded SIFT-like twin.

A copy of vectorsearch_rbac_tpu/data/datasets.py `sift_like_corpus` and
the SIFT branches of `resolve_dataset`, so that the port runs where the
JAX package is absent; tests/test_torch_host.py holds the arrays equal to
the reference's for the same seed. Loading SIFT files (HDF5, .mat) and
the cohere-like and synthetic float corpora come with the slices that
serve them (ROADMAP.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .core import Corpus

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


def resolve_dataset(name: str, num_vectors: int = 1_000_000,
                    seed: int = 0) -> Tuple[Corpus, np.ndarray]:
    """(corpus, query_pool) for a dataset name. "sift", "sift1m" and
    "sift10m" give the seeded SIFT-like twin, as the reference does when
    no dataset file is given."""
    if name in ("sift", "sift1m", "sift10m"):
        return sift_like_corpus(num_vectors=num_vectors, seed=seed)
    raise NotImplementedError(
        f"dataset {name!r}: the cohere-like and synthetic float corpora need "
        "the rerank tiers (ROADMAP slice 2); dataset files are not read yet")
