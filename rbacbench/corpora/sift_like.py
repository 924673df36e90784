"""SIFT-shaped corpus, made on the device from the seed.

The mixture is frozen from vectorsearch_rbac_tpu_torch/data/datasets.py
`sift_like_corpus` and `_group_into_documents` at commit 67fd89a (copies of
the reference's): n_centers = max(64, min(4096, total // 500)) centres with
gamma(1.2, scale 40) components, each row a uniformly drawn centre plus
N(0, 18^2) noise, floored and clipped to [0, 255]; the last `query_pool`
rows of the draw are the held-out query pool; consecutive rows form
documents of `blocks_per_doc` blocks (the last one shorter where the rows
do not split evenly), laid out block-major: every document's block 0, in
document order, then every block 1, and so on, so a document's blocks
spread over the row space. Rows are independent draws, so the layout is
assigned to the rows in the order they are drawn, with no permutation.

The draw runs on `device` with a torch.Generator in chunks of CHUNK rows,
in uint8 (every value is an integer in [0, 255]), and comes to the host
once. The same seed gives the same corpus on the same kind of device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

CHUNK = 1 << 20


@dataclass(frozen=True)
class Corpus:
    rows: np.ndarray       # (N, d) uint8 host copy
    pool: np.ndarray       # (P, d) float32 held-out queries
    doc_ids: np.ndarray    # (N,) int32
    block_ids: np.ndarray  # (N,) int32
    num_docs: int


def draw(total: int, dim: int, seed: int, device) -> torch.Tensor:
    """(total, dim) uint8 rows of the mixture on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_centers = max(64, min(4096, total // 500))
    alpha = torch.full((n_centers, dim), 1.2, dtype=torch.float32,
                       device=device)
    centers = torch._standard_gamma(alpha, generator=gen) * 40.0
    out = torch.empty((total, dim), dtype=torch.uint8, device=device)
    for r0 in range(0, total, CHUNK):
        m = min(CHUNK, total - r0)
        assign = torch.randint(0, n_centers, (m,), generator=gen,
                               device=device)
        noise = torch.randn((m, dim), generator=gen, device=device)
        out[r0:r0 + m] = torch.floor(centers[assign] + noise * 18.0
                                     ).clamp_(0, 255).to(torch.uint8)
    return out


def make(spec: Mapping, seed: int, device) -> Corpus:
    """The corpus a config's "corpus" block describes."""
    n, dim = int(spec["num_vectors"]), int(spec["dim"])
    bpd, n_pool = int(spec["blocks_per_doc"]), int(spec["query_pool"])
    dev_rows = draw(n + n_pool, dim, seed, device)
    host = dev_rows.cpu().numpy()
    del dev_rows
    doc_ids, block_ids = layout(n, bpd)
    return Corpus(rows=host[:n], pool=host[n:].astype(np.float32),
                  doc_ids=doc_ids, block_ids=block_ids,
                  num_docs=-(-n // bpd))


def layout(n: int, bpd: int):
    """(doc_ids, block_ids), (n,) int32 each, of n rows grouped into
    documents of bpd blocks and ordered block-major."""
    full, rest = divmod(n, bpd)
    docs = [full + (b < rest) for b in range(bpd)]   # documents with block b
    doc_ids = np.concatenate([np.arange(c, dtype=np.int32) for c in docs])
    block_ids = np.repeat(np.arange(bpd, dtype=np.int32), docs)
    return doc_ids, block_ids
