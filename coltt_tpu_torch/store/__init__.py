"""The stores: FLAT (every edge mode), CFLAT multi-vector and HNSW, and
state conversion to and from the JAX package (:mod:`.convert`)."""

from coltt_tpu_torch.store.flat import FlatStore
from coltt_tpu_torch.store.multivec import MultiVectorStore
from coltt_tpu_torch.store.hnsw import HnswConfig, HnswIndex

__all__ = ["FlatStore", "MultiVectorStore", "HnswConfig", "HnswIndex"]
