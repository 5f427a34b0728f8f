"""0-100 score normalization (port of ``coltt_tpu/ops/score.py``).

Reference parity: ``core/core_helper.go:250-255`` and
``edge/edge_helper.go:143-148`` — cosine ``((2-d)/2)*100``, euclidean
``max(0, 100-d)`` (d = squared distance).
"""

from __future__ import annotations

import torch

from coltt_tpu_torch.ops.distance import Metric


def normalize_score(dist, metric: Metric):
    """distance -> similarity score on the reference's 0-100 scale."""
    metric = Metric.parse(metric)
    if metric == Metric.COSINE:
        return ((2.0 - dist) / 2.0) * 100.0
    return torch.clamp(100.0 - dist, min=0.0)


def denormalize_score(score, metric: Metric):
    """score -> distance (inverse of :func:`normalize_score`)."""
    metric = Metric.parse(metric)
    if metric == Metric.COSINE:
        return 2.0 - (score / 100.0) * 2.0
    return 100.0 - score
