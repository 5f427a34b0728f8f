"""Carry index state between the JAX package and this port as numpy.

``flat_index_from_arrays`` builds a port :class:`DistributedFlatIndex`
(dense, unit-i8 or BQ) from the arrays of a JAX
``coltt_tpu.parallel.dist_search.DistributedFlatIndex`` fetched to numpy;
:func:`flat_index_to_arrays` is its inverse. ``pq_index_from_arrays`` /
``pq_index_to_arrays`` do the same for a :class:`DistributedPQIndex`, and
:func:`pq_codebook_from_arrays` carries a codebook the JAX package
trained. The tests use them so that both packages search the same state.
Codes and the rerank copy cross as raw bits, as in ``store/convert.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization, storage_dtype
from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex, DistributedPQIndex
from coltt_tpu_torch.store.convert import (
    _from_bits,
    _to_bits,
    pq_codebook_from_arrays,
    pq_codebook_to_arrays,
)

__all__ = ["flat_index_from_arrays", "flat_index_to_arrays",
           "pq_codebook_from_arrays", "pq_index_from_arrays", "pq_index_to_arrays"]


def flat_index_from_arrays(
    *,
    dim: int,
    metric,
    quantization,
    n: int,
    codes: np.ndarray,
    valid: np.ndarray,
    scale: Optional[np.ndarray] = None,
    sqnorm: Optional[np.ndarray] = None,
    rr_codes: Optional[np.ndarray] = None,
    gscale=None,
    bin_live: Optional[np.ndarray] = None,
    compute_dtype=None,
    rerank_dtype=None,
    device="cuda",
) -> DistributedFlatIndex:
    """A port :class:`DistributedFlatIndex` holding exactly these arrays:
    those of a JAX ``DistributedFlatIndex`` fetched to numpy (``gscale``
    and ``bin_live`` make it a unit_i8 index). numpy has no bf16 or f8
    dtype of its own, so codes and ``rr_codes`` cross as raw bits: any
    array of the element width is reinterpreted as the storage dtype of
    ``quantization`` (int8 for unit_i8, int32 words for BQ) and
    ``rerank_dtype``."""
    idx = DistributedFlatIndex.__new__(DistributedFlatIndex)
    idx._configure(device, metric, quantization, compute_dtype, rerank_dtype,
                   unit_i8=gscale is not None)
    idx.n, idx.dim = int(n), int(dim)
    rows = codes.shape[0]
    if idx.quantization == Quantization.BQ:
        code_dtype = torch.int32
    else:
        code_dtype = torch.int8 if idx.unit_i8 else storage_dtype(idx.quantization)
    idx.codes = _from_bits(codes, code_dtype).reshape(rows, -1).to(idx.device)
    idx.valid = torch.from_numpy(np.array(valid, bool).reshape(rows)).to(idx.device)

    def f32(a, shape):
        return (None if a is None else
                torch.from_numpy(np.array(a, np.float32).reshape(shape)).to(idx.device))

    idx.scale = f32(scale, (rows, 1))
    idx.sqnorm = f32(sqnorm, (rows,))
    idx.gscale = f32(gscale, ())
    idx.bin_live = (None if bin_live is None else
                    torch.from_numpy(np.array(bin_live, bool).reshape(-1)).to(idx.device))
    idx.rr_codes = (None if rr_codes is None else
                    _from_bits(rr_codes, rerank_dtype).reshape(rows, dim).to(idx.device))
    return idx


def flat_index_to_arrays(idx: DistributedFlatIndex) -> dict:
    """The index's state as numpy: the keyword arguments of
    :func:`flat_index_from_arrays` (bf16 / f8 as int16 / int8 bits)."""
    def host(t):
        return None if t is None else t.cpu().numpy()

    return {
        "dim": idx.dim,
        "metric": int(idx.metric),
        "quantization": int(idx.quantization),
        "n": idx.n,
        "codes": _to_bits(idx.codes),
        "valid": host(idx.valid),
        "scale": host(idx.scale),
        "sqnorm": host(idx.sqnorm),
        "rr_codes": None if idx.rr_codes is None else _to_bits(idx.rr_codes),
        "gscale": None if idx.gscale is None else float(idx.gscale),
        "bin_live": host(idx.bin_live),
        "compute_dtype": idx.compute_dtype,
        "rerank_dtype": idx.rerank_dtype,
    }


def pq_index_from_arrays(*, metric, codes: np.ndarray, sqnorm: np.ndarray,
                         valid: np.ndarray, codebook: dict, compute_dtype=None,
                         device="cuda") -> DistributedPQIndex:
    """A port :class:`DistributedPQIndex` holding exactly these arrays (a
    JAX ``DistributedPQIndex``'s, fetched) and ``codebook``
    (:func:`pq_codebook_to_arrays`'s dict)."""
    idx = DistributedPQIndex.__new__(DistributedPQIndex)
    idx.device = torch.device(device)
    idx.metric = Metric.parse(metric)
    idx.compute_dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
    idx.codebook = pq_codebook_from_arrays(**codebook, device=idx.device)
    idx.codes = torch.from_numpy(np.array(codes, np.uint8)).to(idx.device)
    idx.n, idx.dim = idx.codes.shape[0], idx.codebook.dim
    idx.sqnorm = torch.from_numpy(np.array(sqnorm, np.float32)).to(idx.device)
    idx.valid = torch.from_numpy(np.array(valid, bool)).to(idx.device)
    return idx


def pq_index_to_arrays(idx: DistributedPQIndex) -> dict:
    """The PQ index's state as numpy: the keyword arguments of
    :func:`pq_index_from_arrays`."""
    return {
        "metric": int(idx.metric),
        "codes": idx.codes.cpu().numpy(),
        "sqnorm": idx.sqnorm.cpu().numpy(),
        "valid": idx.valid.cpu().numpy(),
        "codebook": pq_codebook_to_arrays(idx.codebook),
        "compute_dtype": idx.compute_dtype,
    }
