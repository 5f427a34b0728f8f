"""coltt_tpu_torch: the PyTorch + CUDA port of coltt_tpu.

It keeps the JAX package's module layout and names (``ops/``, ``store/``,
``index/``, ``engine/``, ``storage/``, ``api/``, ``utils/``) and is held
against it on the same inputs: integer codes bit-identical, ids and scores
within stated tolerances, and each package loads the checkpoints the
other writes. Tensors are torch tensors on an explicit device (default
``"cuda"``); the fused scan kernel K1 is CUDA C++ under ``csrc/``, built
at first use. This package never imports JAX.
"""

from coltt_tpu_torch.version import __version__

from coltt_tpu_torch.ops.quant import Quantization
from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.index.schema import CollectionSchema, FieldSchema, FieldType
from coltt_tpu_torch.index.filter import Filter, CompositeFilter, Op, LogicalOp

__all__ = [
    "__version__",
    "Quantization",
    "Metric",
    "CollectionSchema",
    "FieldSchema",
    "FieldType",
    "Filter",
    "CompositeFilter",
    "Op",
    "LogicalOp",
]
