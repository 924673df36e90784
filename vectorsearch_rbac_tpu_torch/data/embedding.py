"""Text to vectors: the embedding contract, a weight-free embedder and the
text-corpus ingestion.

A copy of vectorsearch_rbac_tpu/data/embedding.py `Embedder`,
`HashingEmbedder`, `_chunk_words` and `ingest_text_corpus`, held equal to
it by tests/test_torch_data.py. Each document's text is cut into word
blocks, one vector a block, and the blocks keep their document. The
reference's `TransformersEmbedder` (a local Hugging Face checkpoint) is not
here: no checkpoint is in the repository (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np

from ..config import get_logger
from ..core import Corpus

logger = get_logger("data.embedding")

_TOKEN_RE = re.compile(r"[a-z0-9]+")


class Embedder(Protocol):
    """An embedding service: texts in, unit rows out."""

    dim: int

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        """(len(texts), dim) float32, L2-normalized rows."""
        ...


class HashingEmbedder:
    """Signed feature hashing of word unigrams and bigrams into dim
    buckets (bigrams at half weight), L2-normalized: deterministic and
    free of weights."""

    def __init__(self, dim: int = 300, seed: int = 0):
        self.dim = dim
        self.seed = seed

    def _bucket(self, token: str) -> Tuple[int, float]:
        h = hashlib.blake2b(f"{self.seed}:{token}".encode(),
                            digest_size=8).digest()
        v = int.from_bytes(h, "little")
        return v % self.dim, 1.0 if (v >> 63) & 1 else -1.0

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            toks = _TOKEN_RE.findall(t.lower())
            for j, tok in enumerate(toks):
                b, s = self._bucket(tok)
                out[i, b] += s
                if j + 1 < len(toks):
                    b2, s2 = self._bucket(tok + "_" + toks[j + 1])
                    out[i, b2] += 0.5 * s2
        n = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(n, 1e-12)


def _chunk_words(text: str, words_per_block: int) -> List[str]:
    words = text.split()
    if not words:
        return [""]
    return [" ".join(words[i:i + words_per_block])
            for i in range(0, len(words), words_per_block)]


def ingest_text_corpus(documents: Sequence[str],
                       embedder: Optional[Embedder] = None,
                       words_per_block: int = 64,
                       max_blocks_per_doc: int = 100) -> Corpus:
    """Text documents -> Corpus: each document cut into blocks of
    words_per_block words (at most max_blocks_per_doc), every block
    embedded, the rows in document order."""
    embedder = embedder or HashingEmbedder()
    blocks: List[str] = []
    doc_ids: List[int] = []
    block_ids: List[int] = []
    for di, text in enumerate(documents):
        ch = _chunk_words(text, words_per_block)[:max_blocks_per_doc]
        blocks.extend(ch)
        doc_ids.extend([di] * len(ch))
        block_ids.extend(range(len(ch)))
    vecs = embedder.embed(blocks)
    logger.info("ingested %d docs -> %d blocks (%d-d)",
                len(documents), len(blocks), embedder.dim)
    return Corpus(vectors=np.ascontiguousarray(vecs, dtype=np.float32),
                  doc_ids=np.asarray(doc_ids, dtype=np.int32),
                  block_ids=np.asarray(block_ids, dtype=np.int32))
