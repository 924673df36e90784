"""Flat exact index over the whole arena: the ground-truth oracle's engine.

Counterpart of vectorsearch_rbac_tpu/index/flat.py `FlatIndex` in exact
mode over the whole arena, and its `_pad_to_bucket` row-count rule, which
the int8 index's partitions share. The exact index over row subsets and
the approx mode are ROADMAP slice 4."""

from __future__ import annotations

import math

from typing import Dict, Tuple

import numpy as np
import torch

from ..core import DeviceArena
from ..ops.scan import masked_scan_topk


def _pad_to_bucket(n: int, block_rows: int) -> int:
    """Pad a row count to block_rows times a power-of-two number of blocks
    (the reference's rule: a partition's padded size, and through it the
    int8 index's group width, follow from it)."""
    n_blocks = max(1, math.ceil(n / block_rows))
    bucket = 1 << (n_blocks - 1).bit_length()
    return bucket * block_rows


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
