from .flat import FlatIndex
from .flat_int8 import Int8FlatIndex
from .hnsw import HNSWIndex

__all__ = ["FlatIndex", "Int8FlatIndex", "HNSWIndex"]
