"""Ratings files: the JAX package's columnar format, read through a native
mmap loader with threaded prefetch (``ratings``)."""

from .ratings import RatingsDataset, load_native, write_ratings

__all__ = ["RatingsDataset", "write_ratings", "load_native"]
