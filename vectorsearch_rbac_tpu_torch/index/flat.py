"""Flat exact index over the whole arena: the ground-truth oracle's engine.

Counterpart of vectorsearch_rbac_tpu/index/flat.py `FlatIndex` in exact
mode over the whole arena. Row subsets (physical partitions) belong to the
partitioned strategies (ROADMAP slice 3), the approx mode to slice 4."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import DeviceArena
from ..ops.scan import masked_scan_topk


class FlatIndex:
    def __init__(self, arena: DeviceArena, block_rows: int = 16384,
                 query_batch: int = 256):
        self.block_rows = block_rows
        self.query_batch = query_batch
        self.n_rows = arena.n
        self.metric = arena.metric
        self._arena = arena

    def search_deferred(self, queries: np.ndarray, query_masks: np.ndarray,
                        k: int):
        """Enqueue the scans without syncing; returns finalize() ->
        (dists (Q, k) float32, arena row ids (Q, k) int64)."""
        a = self._arena
        dev = a.device
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(
            query_masks, np.uint32).view(np.int32)).to(dev)
        pending = [
            masked_scan_topk(q[s:s + self.query_batch],
                             a.vectors, a.norms, a.role_bits,
                             m[s:s + self.query_batch], k, self.block_rows,
                             self.metric)
            for s in range(0, q.shape[0], self.query_batch)]

        def finalize():
            if not pending:
                return (np.empty((0, k), np.float32),
                        np.empty((0, k), np.int64))
            d = torch.cat([p[0] for p in pending]).cpu().numpy()
            i = torch.cat([p[1] for p in pending]).cpu().numpy()
            return d, i.astype(np.int64)

        return finalize

    def search(self, queries, query_masks, k) -> Tuple[np.ndarray, np.ndarray]:
        return self.search_deferred(queries, query_masks, k)()

    def storage_bytes(self) -> Dict[str, int]:
        return {"vectors": 0, "index": 0}  # the shared arena, counted there
