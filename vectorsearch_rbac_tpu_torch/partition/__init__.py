from .base import BuiltPartition, PartitionedSearcher, make_partition_index
from .strategies import STRATEGIES, build_global_searcher, build_searcher

__all__ = [
    "BuiltPartition",
    "PartitionedSearcher",
    "make_partition_index",
    "build_global_searcher",
    "build_searcher",
    "STRATEGIES",
]
