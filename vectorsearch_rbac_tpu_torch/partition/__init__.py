from .base import BuiltPartition, PartitionedSearcher, make_partition_index
from .graph_batch import GraphProbeBatcher
from .packed import PackedSearcher
from .qdtree import QDTree, build_qd_tree, build_qdtree_searcher
from .strategies import (STRATEGIES, build_comb_searcher,
                         build_global_searcher, build_role_searcher,
                         build_searcher)
from .tiled import TiledSearcher

__all__ = [
    "BuiltPartition",
    "GraphProbeBatcher",
    "PackedSearcher",
    "QDTree",
    "build_qd_tree",
    "build_qdtree_searcher",
    "PartitionedSearcher",
    "TiledSearcher",
    "make_partition_index",
    "build_global_searcher",
    "build_role_searcher",
    "build_comb_searcher",
    "build_searcher",
    "STRATEGIES",
]
