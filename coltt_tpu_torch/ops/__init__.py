"""Primitives: quantization, distances, scores, top-k and the fused scan kernel."""

from coltt_tpu_torch.ops.quant import (
    Quantization,
    storage_dtype,
    quantize,
    dequantize,
)
from coltt_tpu_torch.ops.distance import Metric, pairwise_distance, distance_pair
from coltt_tpu_torch.ops.score import normalize_score, denormalize_score

__all__ = [
    "Quantization",
    "storage_dtype",
    "quantize",
    "dequantize",
    "Metric",
    "pairwise_distance",
    "distance_pair",
    "normalize_score",
    "denormalize_score",
]
