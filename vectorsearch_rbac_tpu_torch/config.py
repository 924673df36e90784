"""Serving configuration and the package logger.

The fields of vectorsearch_rbac_tpu/utils/config.py `FrameworkConfig` that
the ported paths read, with the reference's defaults and the same nesting
(`cfg.search.*`, `cfg.index.*`, `cfg.optimizer.*`), so that a reference
config object works here too. The reference's `search.recall_target`,
the target of its approximate per-block top-k, is not here: every scan of
the port takes the exact top-k.
"""

from __future__ import annotations

import logging
import os
import sys
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class SearchConfig:
    topk: int = 10
    ef_search: int = 40          # HNSW beam width (pgvector hnsw.ef_search)
    nprobe: int = 16             # IVF probes (pgvector ivfflat.probes)
    batch_size: int = 256        # queries per device dispatch
    block_rows: int = 16384      # arena rows per scan block
    dtype: str = "float32"       # arena dtype: "float32" | "bfloat16" |
                                 # "int8"
    scan_group: int = 32         # tiled chunk engine: packed group-min
                                 # width (0 = exact per-chunk top-k)
    wire_dist: str = "u8"        # the global index's result wire: "u8" (a
                                 # per-query affine byte), "bf16", "f32"
                                 # (exact) or "ids" (no distances: callers
                                 # get rank pseudo-distances); partition
                                 # tiers always carry f32


@dataclass
class IndexConfig:
    kind: str = "flat"           # "flat" | "flat_approx" | "ivf" | "hnsw"
                                 # | "hybrid" | "binary"
    hnsw_m: int = 16
    hnsw_ef_construction: int = 64
    hnsw_m_beta: int = 0         # > 0: the ACORN builder, dense layer-0
                                 # lists of this width (the reference's
                                 # gamma 12, M_beta 64) for filtered search
    ivf_nlist: int = 1024        # IVF lists (k-means centroids)
    ivf_kmeans_iters: int = 10   # Lloyd iterations of the IVF build
    # hybrid (dynamic partitions): a partition serves from an HNSW graph
    # only when every comb routed to it keeps within-partition selectivity
    # >= this threshold; mixed partitions take the int8 flat scan
    hybrid_sel_threshold: float = 0.5
    # the binary index (index/binary.py): an exact rerank from the shared
    # arena over rerank_mult * k bit-distance candidates, or the bit
    # distance itself ("hamming" or "jaccard") without it
    binary_rerank: bool = True
    binary_rerank_mult: int = 4
    binary_bit_metric: str = "hamming"
    # HNSW partitions serve from the shared arena through their row maps
    # (no per-partition vector copy; batchable into the graph batcher's
    # slabs) when True; False, the reference's default, gives each graph
    # its own device copy of its rows (index/hnsw.py)
    hnsw_logical: bool = False
    big_logical: bool = False    # tiled big tier: gather the partition's
                                 # rows from the shared arena per pass
                                 # instead of keeping a contiguous copy


@dataclass
class OptimizerConfig:
    """AnonySys dynamic-partition planner knobs (the reference's defaults:
    the fitted pgvector HNSW cost model)."""

    storage_alpha: float = 1.5   # storage budget multiple of corpus size
    target_recall: Optional[float] = None
    topk: int = 10
    recall_k: float = 1.0
    recall_beta: float = 0.44240961
    qps_a: float = 550.97
    qps_b: float = 183157.0
    join_time: float = 0.0
    ef_offset: float = 0.0
    n_ref: float = 0.0
    gamma_n: float = 0.0


@dataclass
class FrameworkConfig:
    seed: int = 0
    search: SearchConfig = field(default_factory=SearchConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)


_configured = False


def get_logger(name: str) -> logging.Logger:
    """A logger under "vsrbac.torch" with one shared stderr handler; the
    level comes from $VSRBAC_LOG_LEVEL (default INFO)."""
    global _configured
    root = logging.getLogger("vsrbac.torch")
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(os.environ.get("VSRBAC_LOG_LEVEL", "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(f"vsrbac.torch.{name}")
