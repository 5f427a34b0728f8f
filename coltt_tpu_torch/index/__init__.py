"""Schema, filter expressions and the bitmap inverted index."""

from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu_torch.index.filter import (
    CompositeFilter,
    Filter,
    FilterExpression,
    LogicalOp,
    Op,
)
from coltt_tpu_torch.index.bitmap import Bitset, InvertedIndex

__all__ = [
    "CollectionSchema",
    "FieldSchema",
    "FieldType",
    "Filter",
    "CompositeFilter",
    "Op",
    "LogicalOp",
    "FilterExpression",
    "Bitset",
    "InvertedIndex",
]
