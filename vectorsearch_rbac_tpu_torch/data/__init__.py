"""Corpora: the seeded twins, the dataset-file readers, the sparse corpus
and the text ingestion (the reference's data/ package)."""

from .datasets import (SIFT_DOCUMENT_VECTOR_COUNT, cohere_like_corpus,
                       load_arxiv_categories, load_embedding_dump,
                       load_sift10m, load_sift_hdf5, resolve_dataset,
                       sift_like_corpus, synthetic_corpus)
from .embedding import Embedder, HashingEmbedder, ingest_text_corpus
from .sparse import SparseCorpus, synthetic_sparse_corpus

__all__ = [
    "SIFT_DOCUMENT_VECTOR_COUNT", "synthetic_corpus", "sift_like_corpus",
    "cohere_like_corpus", "load_sift_hdf5", "load_sift10m",
    "load_embedding_dump", "load_arxiv_categories", "resolve_dataset",
    "Embedder", "HashingEmbedder", "ingest_text_corpus", "SparseCorpus",
    "synthetic_sparse_corpus",
]
