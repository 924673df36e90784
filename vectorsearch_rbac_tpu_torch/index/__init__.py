from .flat import FlatIndex
from .flat_int8 import Int8FlatIndex

__all__ = ["FlatIndex", "Int8FlatIndex"]
