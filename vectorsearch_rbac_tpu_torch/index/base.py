"""The index contract: what a partition's searcher provides.

A copy of vectorsearch_rbac_tpu/index/base.py `PartitionIndex`: a (Q, d)
query batch with (Q, W) role masks goes in, arena row ids come out, and
storage is reported as vector payload and index structure. Every index of
the port (flat, int8 flat, IVF, HNSW, binary, sparse) satisfies it.
"""

from __future__ import annotations

from typing import Dict, Protocol, Tuple

import numpy as np


class PartitionIndex(Protocol):
    n_rows: int  # valid (unpadded) rows covered by this index

    def search(
        self,
        queries: np.ndarray,      # (Q, d) float32
        query_masks: np.ndarray,  # (Q, W) uint32
        k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(dists (Q, k) ascending in the arena's metric, arena row ids
        (Q, k)); empty slots +inf and -1. Every returned row passes the
        role-mask test inside the index, never as a post-filter."""
        ...

    def storage_bytes(self) -> Dict[str, int]:
        """{"vectors": payload bytes, "index": structure bytes (graphs,
        centroids, bitsets, row maps)}."""
        ...
