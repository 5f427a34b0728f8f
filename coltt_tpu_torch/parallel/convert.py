"""Carry index state between the JAX package and this port as numpy.

``flat_index_from_arrays`` builds a port :class:`DistributedFlatIndex`
(dense, unit-i8 or BQ) from the arrays of a JAX
``coltt_tpu.parallel.dist_search.DistributedFlatIndex`` fetched to numpy;
:func:`flat_index_to_arrays` is its inverse. ``pq_index_from_arrays`` /
``pq_index_to_arrays`` do the same for a :class:`DistributedPQIndex`, and
:func:`pq_codebook_from_arrays` carries a codebook the JAX package
trained. The tests use them so that both packages search the same state.
Codes and the rerank copy cross as raw bits, as in ``store/convert.py``.
``device`` may be a :class:`~coltt_tpu_torch.parallel.mesh.Mesh`: the rows
are then cut into its shards, as a JAX index sharded over as many devices
holds them (the global arrays are the same either way).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric
from coltt_tpu_torch.ops.quant import Quantization, storage_dtype
from coltt_tpu_torch.parallel.dist_search import DistributedFlatIndex, DistributedPQIndex
from coltt_tpu_torch.parallel.mesh import ShardedRows, replicate, split
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
    put = _placer(idx.mesh, idx.device)
    idx.codes = put(_from_bits(codes, code_dtype).reshape(rows, -1))
    idx.valid = put(torch.from_numpy(np.array(valid, bool).reshape(rows)))

    def f32(a, shape):
        return (None if a is None else
                put(torch.from_numpy(np.array(a, np.float32).reshape(shape))))

    idx.scale = f32(scale, (rows, 1))
    idx.sqnorm = f32(sqnorm, (rows,))
    idx.gscale = None
    if gscale is not None:
        g = torch.tensor(float(np.float32(gscale)), dtype=torch.float32)
        idx.gscale = g.to(idx.device) if idx.mesh is None else replicate(idx.mesh, g)
    idx.bin_live = (None if bin_live is None else
                    put(torch.from_numpy(np.array(bin_live, bool).reshape(-1))))
    idx.rr_codes = (None if rr_codes is None else
                    put(_from_bits(rr_codes, rerank_dtype).reshape(rows, dim)))
    return idx


def _placer(mesh, device):
    """Host tensor -> the index's layout: on ``device``, or cut into the
    mesh's shards."""
    if mesh is None:
        return lambda t: t.to(device)
    return lambda t: ShardedRows.place(mesh, t)


def _gscale(g) -> float:
    """A unit-i8 index's global scale (a tensor, or a mesh's replicas)."""
    return float(next(iter(g.values())) if isinstance(g, dict) else g)


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
        "gscale": None if idx.gscale is None else _gscale(idx.gscale),
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
    idx.mesh, idx.device, idx.placement = split(device)
    idx.metric = Metric.parse(metric)
    idx.compute_dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
    idx.codebook = pq_codebook_from_arrays(**codebook, device=idx.device)
    put = _placer(idx.mesh, idx.device)
    idx.codes = put(torch.from_numpy(np.array(codes, np.uint8)))
    idx.n, idx.dim = idx.codes.shape[0], idx.codebook.dim
    idx.sqnorm = put(torch.from_numpy(np.array(sqnorm, np.float32)))
    idx.valid = put(torch.from_numpy(np.array(valid, bool)))
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
