"""Flat index: the masked scan over the whole arena or a row subset.

Counterpart of vectorsearch_rbac_tpu/index/flat.py `FlatIndex` and its
`_pad_to_bucket` row-count rule, which the int8 index's partitions share.
Over the whole arena it is the global scan (and the ground-truth oracle's
engine, in exact mode on a float32 arena) and reads the arena's tensors;
over a row subset it is a physical partition: its rows, norms and
bitsets are gathered on the device along a row map padded to
`_pad_to_bucket` (pads are zero rows with zero bits, row id -1), and ids
return through that map as arena row ids. Mode "approx" scans the
augmented layout [x | norm_hi | norm_lo | 0] (core.augment_with_norms),
which the index builds for its rows on every metric but l1 and counts in
storage_bytes (the reference counts it nowhere); both modes take the
exact top-k (ops/scan.py). The reference's `dtype` (a partition's
compute dtype) and `recall_target` are not carried: a partition keeps the
arena's dtype, and no scan is approximate.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import DeviceArena, augment_with_norms
from ..ops.scan import masked_scan_topk, masked_scan_topk_aug
from .ivf import gather_lists


def _pad_to_bucket(n: int, block_rows: int) -> int:
    """Pad a row count to block_rows times a power-of-two number of blocks
    (the reference's rule: a partition's padded size, and through it the
    int8 index's group width, follow from it)."""
    n_blocks = max(1, math.ceil(n / block_rows))
    bucket = 1 << (n_blocks - 1).bit_length()
    return bucket * block_rows


class FlatIndex:
    def __init__(self, arena: DeviceArena,
                 rows: Optional[np.ndarray] = None,
                 block_rows: int = 16384, mode: str = "exact",
                 query_batch: int = 256):
        """rows: arena row ids (None: the whole arena)."""
        if mode not in ("exact", "approx"):
            raise ValueError(f"unknown mode {mode!r}")
        self.block_rows = block_rows
        self.mode = mode
        self.query_batch = query_batch
        self.metric = arena.metric
        if rows is None:
            self.n_rows = arena.n
            self._vectors, self._norms = arena.vectors, arena.norms
            self._bits = arena.role_bits
            self._row_map = None
        else:
            rows = np.asarray(rows, dtype=np.int64)
            self.n_rows = len(rows)
            npad = _pad_to_bucket(max(self.n_rows, 1), block_rows)
            rmap = np.full(npad, -1, dtype=np.int64)
            rmap[:self.n_rows] = rows
            self._row_map = torch.from_numpy(rmap).to(arena.device)
            vec, norms, bits = gather_lists(arena.vectors, arena.norms,
                                            arena.role_bits,
                                            self._row_map[None, :])
            self._vectors, self._norms, self._bits = vec[0], norms[0], bits[0]
        self._vectors_aug = (augment_with_norms(
            self._vectors.to(torch.float32), self._norms).to(
                self._vectors.dtype)
            if mode == "approx" and self.metric != "l1" else None)

    def search_deferred(self, queries: np.ndarray, query_masks: np.ndarray,
                        k: int):
        """Enqueue the scans without syncing; returns finalize() ->
        (dists (Q, k) float32, arena row ids (Q, k) int64)."""
        dev = self._vectors.device
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(
            query_masks, np.uint32).view(np.int32)).to(dev)
        pending = []
        for s in range(0, q.shape[0], self.query_batch):
            qb, mb = q[s:s + self.query_batch], m[s:s + self.query_batch]
            if self._vectors_aug is not None:
                d, i = masked_scan_topk_aug(
                    qb, self._vectors_aug, self._bits, mb, k,
                    self.block_rows, metric=self.metric)
            else:
                d, i = masked_scan_topk(
                    qb, self._vectors, self._norms, self._bits, mb, k,
                    self.block_rows, metric=self.metric)
            if self._row_map is not None:
                i = torch.where(i < 0, -1,
                                self._row_map[i.clamp_min(0).long()])
            pending.append((d, i))

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
        """The index's own bytes: a partition's rows in their dtype and 4 +
        4 W + 4 bytes a row of norms, bitsets and row map, as the reference
        counts them (the whole arena's index adds none: counted there),
        and in approx mode the augmented layout under "vectors"."""
        aug = (0 if self._vectors_aug is None else
               self._vectors_aug.numel() * self._vectors_aug.element_size())
        if self._row_map is None:
            return {"vectors": int(aug), "index": 0}
        npad, d = self._vectors.shape
        w = self._bits.shape[1]
        return {"vectors": int(npad * d * self._vectors.element_size()
                               + aug),
                "index": int(npad * (4 + 4 * w + 4))}
