from .base import PartitionIndex
from .binary import BinaryQuantIndex
from .flat import FlatIndex
from .flat_int8 import Int8FlatIndex
from .hnsw import HNSWIndex
from .ivf import IVFIndex, ivf_from_reference
from .sparse import SparseFlatIndex

__all__ = ["PartitionIndex", "BinaryQuantIndex", "FlatIndex",
           "Int8FlatIndex", "HNSWIndex", "IVFIndex", "ivf_from_reference",
           "SparseFlatIndex"]
