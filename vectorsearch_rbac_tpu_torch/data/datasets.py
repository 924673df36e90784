"""The seeded corpora and the dataset-file readers.

A copy of vectorsearch_rbac_tpu/data/datasets.py: the SIFT-like,
cohere-like and float synthetic twins, the readers of the ann-benchmarks
SIFT HDF5 file, the SIFT10M .mat file (both through h5py, imported when a
file is read), embedding dumps (.npy, .npz, .parquet through pandas,
.hdf5) and arXiv's metadata categories, and `resolve_dataset`, which reads
a file where one is given and falls back to the seeded twin, as the
reference does. tests/test_torch_host.py and tests/test_torch_data.py hold
the arrays equal to the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..core import Corpus

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


def load_sift_hdf5(path: str,
                   blocks_per_doc: int = SIFT_DOCUMENT_VECTOR_COUNT,
                   max_vectors: Optional[int] = None
                   ) -> Tuple[Corpus, np.ndarray]:
    """An ann-benchmarks HDF5 file (sift-128-euclidean.hdf5): its 'train'
    base vectors as the corpus, its 'test' vectors as the query pool."""
    import h5py   # only where a file is read; raises ImportError without it

    with h5py.File(path, "r") as f:
        train = np.asarray(f["train"], dtype=np.float32)
        test = np.asarray(f["test"], dtype=np.float32)
    if max_vectors is not None:
        train = train[:max_vectors]
    return _group_into_documents(train, blocks_per_doc), test


def load_sift10m(path: str, blocks_per_doc: int = SIFT_DOCUMENT_VECTOR_COUNT,
                 max_vectors: Optional[int] = None
                 ) -> Tuple[Corpus, np.ndarray]:
    """SIFT10M's 'fea' matrix from its v7.3 .mat file; the last 10,000
    rows are the query pool."""
    import h5py

    with h5py.File(path, "r") as f:
        fea = np.asarray(f["fea"], dtype=np.float32)
    if fea.shape[0] < fea.shape[1]:   # MATLAB stores it column-major
        fea = fea.T
    if max_vectors is not None:
        fea = fea[:max_vectors + 10_000]
    base, queries = fea[:-10_000], fea[-10_000:]
    return _group_into_documents(base, blocks_per_doc), queries


def load_embedding_dump(path: str,
                        blocks_per_doc: int = SIFT_DOCUMENT_VECTOR_COUNT,
                        max_vectors: Optional[int] = None,
                        query_holdout: int = 10_000
                        ) -> Tuple[Corpus, np.ndarray]:
    """An embedding dump (.npy, .npz, .parquet or .hdf5) as a corpus. The
    queries come from `<stem>_queries.npy` where it exists, else the last
    min(query_holdout, rows // 10) rows are held out."""
    stem, ext = os.path.splitext(path)
    ext = ext.lower()
    if ext == ".npy":
        vecs = np.asarray(np.load(path, mmap_mode="r"), dtype=np.float32)
    elif ext == ".npz":
        with np.load(path) as z:
            key = "embeddings" if "embeddings" in z.files else z.files[0]
            vecs = np.asarray(z[key], dtype=np.float32)
    elif ext == ".parquet":
        import pandas as pd   # parquet needs pandas and pyarrow

        df = pd.read_parquet(path)
        col = next(c for c in ("emb", "embedding", "embeddings", "vector")
                   if c in df.columns)
        vecs = np.asarray(np.stack(df[col].to_numpy()), dtype=np.float32)
    elif ext in (".hdf5", ".h5"):
        return load_sift_hdf5(path, blocks_per_doc=blocks_per_doc,
                              max_vectors=max_vectors)
    else:
        raise ValueError(f"unsupported embedding dump format: {path}")
    qpath = stem + "_queries.npy"
    if os.path.isfile(qpath):
        queries = np.asarray(np.load(qpath), dtype=np.float32)
        base = vecs
    else:
        holdout = min(query_holdout, max(len(vecs) // 10, 1))
        base, queries = vecs[:-holdout], vecs[-holdout:]
    if max_vectors is not None:
        base = base[:max_vectors]
    return _group_into_documents(np.ascontiguousarray(base),
                                 blocks_per_doc), queries


def load_arxiv_categories(path: str,
                          max_docs: Optional[int] = None) -> np.ndarray:
    """arXiv's metadata (JSON lines) -> (num_docs,) int64 category ids,
    numbered in order of first appearance, from each paper's primary
    category: the doc_categories of rbac.ArxivBusinessRBACGenerator."""
    cats: list = []
    cat_ids: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            primary = str(rec.get("categories", "unknown")).split()[0]
            cats.append(cat_ids.setdefault(primary, len(cat_ids)))
            if max_docs is not None and len(cats) >= max_docs:
                break
    return np.asarray(cats, dtype=np.int64)


def resolve_dataset(name: str, dataset_path: str = "",
                    num_vectors: int = 1_000_000,
                    seed: int = 0) -> Tuple[Corpus, np.ndarray]:
    """(corpus, query_pool) for a dataset name, read from dataset_path
    where it holds the dataset's file and the seeded twin otherwise:
    "sift" and "sift1m" (sift-128-euclidean.hdf5, or the file itself) and
    "sift10m" (SIFT10Mfeatures.mat) fall back to the SIFT-like twin,
    "cohere" and "wikipedia" (an embedding dump) to the cohere-like one;
    "synthetic" is standard-normal rows in documents of 100 with a pool of
    10,000 standard-normal queries drawn from seed + 1."""
    if name in ("sift", "sift1m"):
        for cand in (os.path.join(dataset_path, "sift-128-euclidean.hdf5"),
                     dataset_path):
            if cand and os.path.isfile(cand):
                return load_sift_hdf5(cand, max_vectors=num_vectors)
        return sift_like_corpus(num_vectors=num_vectors, seed=seed)
    if name == "sift10m":
        cand = os.path.join(dataset_path, "SIFT10Mfeatures.mat")
        if os.path.isfile(cand):
            return load_sift10m(cand, max_vectors=num_vectors)
        return sift_like_corpus(num_vectors=num_vectors, seed=seed)
    if name in ("cohere", "wikipedia"):
        candidates = [dataset_path] if os.path.isfile(dataset_path) else [
            os.path.join(dataset_path, f"{name}{ext}")
            for ext in (".npy", ".npz", ".parquet", ".hdf5")
        ] + [os.path.join(dataset_path,
                          "wikipedia-22-12-en-embeddings.parquet")]
        for cand in candidates:
            if cand and os.path.isfile(cand):
                return load_embedding_dump(cand, max_vectors=num_vectors)
        return cohere_like_corpus(num_vectors=num_vectors, seed=seed)
    if name == "synthetic":
        corpus = synthetic_corpus(
            num_docs=num_vectors // SIFT_DOCUMENT_VECTOR_COUNT,
            blocks_per_doc=SIFT_DOCUMENT_VECTOR_COUNT, seed=seed)
        rng = np.random.default_rng(seed + 1)
        return corpus, rng.standard_normal((10_000, corpus.dim)).astype(
            np.float32)
    raise ValueError(f"unknown dataset {name}")
