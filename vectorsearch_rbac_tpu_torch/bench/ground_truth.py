"""Exact ground-truth oracle with a disk cache, and recall.

Counterpart of vectorsearch_rbac_tpu/bench/ground_truth.py: an exact
masked scan over the whole arena on the port's FlatIndex (a float32
arena: TF32 off; l1 by the scan's l1 form), cached on disk under the
reference's content-hash key of (corpus, world, workload, k, metric).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

from ..config import get_logger
from ..core import Corpus, DeviceArena
from ..index.flat import FlatIndex
from ..rbac import RBACWorld
from .queries import QueryWorkload

logger = get_logger("ground_truth")


def _workload_digest(corpus: Corpus, world: RBACWorld,
                     workload: QueryWorkload, k: int,
                     metric: str = "l2") -> str:
    """The reference's cache key: other metrics than l2 prefix their name,
    so l2 keys stay as they were."""
    h = hashlib.sha256()
    if metric != "l2":
        h.update(metric.encode())
    # ALL query vectors + the full user assignment
    h.update(np.ascontiguousarray(workload.vectors, dtype=np.float32).tobytes())
    h.update(np.ascontiguousarray(workload.user_ids).tobytes())
    h.update(str((corpus.n, corpus.dim, world.num_roles, world.num_users,
                  k)).encode())
    # corpus content fingerprint: strided row sample
    stride = max(1, corpus.n // 1024)
    sample = np.ascontiguousarray(corpus.vectors[::stride], dtype=np.float32)
    h.update(sample.tobytes())
    h.update(np.ascontiguousarray(corpus.doc_ids[::stride]).tobytes())
    # world fingerprint: per-role doc counts plus a content hash of the
    # role->doc assignment itself
    counts = sorted((r, len(d)) for r, d in world.role_to_docs.items())
    h.update(json.dumps(counts).encode())
    for r in sorted(world.role_to_docs):
        docs = np.fromiter(world.role_to_docs[r], dtype=np.int64,
                           count=len(world.role_to_docs[r]))
        docs.sort()
        h.update(docs[:: max(1, len(docs) // 64)].tobytes())
    return h.hexdigest()[:24]


class GroundTruthOracle:
    """Exact masked kNN for every query of a workload, cached on disk."""

    def __init__(self, arena: DeviceArena, cache_dir: Optional[str] = None,
                 block_rows: int = 16384, query_batch: int = 256):
        self._index = FlatIndex(arena, block_rows=block_rows,
                                query_batch=query_batch)
        self.cache_dir = cache_dir

    def compute(self, corpus: Corpus, world: RBACWorld,
                workload: QueryWorkload, k: int) -> np.ndarray:
        """Return (Q, k) arena row ids of the exact top-k (-1 pads)."""
        cache_path = None
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            digest = _workload_digest(corpus, world, workload, k,
                                      self._index.metric)
            cache_path = os.path.join(self.cache_dir, f"gt_{digest}.npy")
            if os.path.exists(cache_path):
                logger.info("ground truth cache hit: %s", cache_path)
                return np.load(cache_path)
        qmasks = world.user_masks[workload.user_ids]
        _, idx = self._index.search(workload.vectors, qmasks, k)
        if cache_path:
            np.save(cache_path, idx)
            logger.info("ground truth cached: %s", cache_path)
        return idx


def per_query_recall(result_ids: np.ndarray,
                     truth_ids: np.ndarray) -> np.ndarray:
    """Recall@k per query: |result & truth| / |truth|, ignoring -1 pads.
    Queries with empty truth are skipped (not counted as 1.0)."""
    recalls = []
    for got, want in zip(result_ids, truth_ids):
        w = set(int(x) for x in want if x >= 0)
        if not w:
            continue
        g = set(int(x) for x in got if x >= 0)
        recalls.append(len(g & w) / len(w))
    return np.asarray(recalls, dtype=np.float64)


def compute_recall(result_ids: np.ndarray, truth_ids: np.ndarray) -> float:
    """Mean recall@k over queries."""
    r = per_query_recall(result_ids, truth_ids)
    return float(np.mean(r)) if r.size else 1.0
