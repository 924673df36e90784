"""Partitioned search engine, for the single global partition.

Counterpart of vectorsearch_rbac_tpu/partition/base.py: the index factory
and the PartitionedSearcher a strategy returns. The port has the global
(RLS) layout only, where every query routes to the one partition over the
whole arena; multi-partition routing, per-probe parameters and the
cross-partition merge come with the partitioned strategies (ROADMAP
slice 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import FrameworkConfig
from ..core import DeviceArena
from ..index.flat import FlatIndex
from ..index.flat_int8 import Int8FlatIndex
from ..rbac import query_masks_for


def make_partition_index(arena: DeviceArena, rows: Optional[np.ndarray],
                         cfg: FrameworkConfig):
    """Index factory over the whole arena (rows=None): "flat_approx" on a
    quantized arena is the int8 fused scan, "flat" the exact f32 scan."""
    if rows is not None:
        raise NotImplementedError(
            "indexes over row subsets (partitions) are ROADMAP slice 3")
    kind = cfg.index.kind
    if kind == "flat_approx" and arena.quant is not None:
        return Int8FlatIndex(arena, query_batch=cfg.search.batch_size,
                             wire=cfg.search.wire_dist)
    if kind == "flat":
        return FlatIndex(arena, block_rows=cfg.search.block_rows,
                         query_batch=cfg.search.batch_size)
    raise NotImplementedError(
        f"index kind {kind!r} (dtype {'int8' if arena.quant else 'float32'}) "
        "is not ported: the f32 approx scan, IVF, HNSW and binary indexes "
        "are ROADMAP slice 4")


@dataclass
class BuiltPartition:
    pid: int
    rows: Optional[np.ndarray]   # arena row ids; None = whole arena
    index: object
    label: str = ""


class PartitionedSearcher:
    """A strategy instance: here one partition that every query routes to
    (the reference's user -> partitions router comes with slice 3)."""

    def __init__(self, arena: DeviceArena,
                 partitions: Dict[int, BuiltPartition], name: str):
        if len(partitions) != 1:
            raise NotImplementedError(
                "multi-partition strategies are ROADMAP slice 3; the port "
                "serves one global partition")
        self.arena = arena
        self.partitions = partitions
        self.name = name

    def search_batch(self, queries: np.ndarray, user_ids: np.ndarray,
                     user_masks: np.ndarray,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (dists (Q, k), arena_row_ids (Q, k)); -1/inf pads."""
        return self.search_batch_deferred(queries, user_ids, user_masks, k)()

    def search_batch_deferred(self, queries: np.ndarray,
                              user_ids: np.ndarray, user_masks: np.ndarray,
                              k: int):
        """Enqueue a pass and return finalize() -> (dists, ids). Every query
        routes to the one global partition."""
        (part,) = self.partitions.values()
        qmasks = query_masks_for(user_masks, np.asarray(user_ids))
        return part.index.search_deferred(
            np.asarray(queries, dtype=np.float32), qmasks, k)

    def storage_report(self) -> Dict[str, float]:
        """MB accounting: the shared arena plus per-partition structures."""
        a = self.arena
        arena_vec = a.n_padded * a.dim * a.vectors.element_size()
        arena_aux = a.n_padded * (4 + 4 * a.role_bits.shape[1])
        part_vec = part_idx = 0
        for p in self.partitions.values():
            sb = p.index.storage_bytes()
            part_vec += sb["vectors"]
            part_idx += sb["index"]
        mb = 1024 * 1024
        return {
            "arena_vectors_mb": arena_vec / mb,
            "arena_aux_mb": arena_aux / mb,
            "partition_vectors_mb": part_vec / mb,
            "partition_index_mb": part_idx / mb,
            "total_mb": (arena_vec + arena_aux + part_vec + part_idx) / mb,
            "num_partitions": len(self.partitions),
        }
