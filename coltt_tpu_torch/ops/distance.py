"""Batched distances on torch tensors.

Port of ``coltt_tpu/ops/distance.py``. A whole scan is one
``[Q, D] x [N, D] -> [Q, N]`` product plus an elementwise epilogue over
precomputed squared norms, so the quantized codes are read once:

    cosine    d = 1 - dot / (|q| * sqrt(sqnorm))
    euclidean d = |q|^2 + sqnorm - 2 * dot              (squared)
    manhattan d = sum |q - v|                            (chunked loop)

Per-row dequant scales fold into the epilogue: dot(q, codes*scale) =
(q @ codes^T) * scale^T. Invalid (tombstoned) rows get +inf distance.
This is the plain path: products go to PyTorch (the JAX package leaves
them to XLA); the fused scan kernel lives in :mod:`.fused_scan`.
"""

from __future__ import annotations

import enum

import torch
import torch.nn.functional as F


class Metric(enum.IntEnum):
    """Matches the proto Distance enum (Cosine=0, Euclidean=1); manhattan is
    kernel-layer only in the reference too (never exposed in a proto)."""

    COSINE = 0
    EUCLIDEAN = 1
    MANHATTAN = 2

    @classmethod
    def parse(cls, v) -> "Metric":
        if isinstance(v, Metric):
            return v
        if isinstance(v, str):
            return cls[v.strip().upper()]
        return cls(int(v))


_EPS = 1e-30


def quantize_queries_i8(queries: torch.Tensor):
    """Per-query symmetric int8: ``(codes [Q, D] int8, qscale [Q, 1] f32)``."""
    qmax = queries.abs().amax(dim=-1, keepdim=True)
    qscale = torch.where(qmax > 0, qmax / 127.0, torch.ones_like(qmax))
    return torch.round(queries / qscale).clamp(-127, 127).to(torch.int8), qscale


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product ``a @ b.T``: ``[M, K] x [N, K] -> [M, N]``.

    ``torch.matmul`` on int8 tensors returns int8 and wraps silently, so
    this goes through ``torch._int_mm``, which accumulates in int32 on the
    CPU and on CUDA. On CUDA it needs M > 16 and K, N multiples of 8:
    shapes are padded with zero rows/columns, which add nothing to a dot
    (the store's N and D are multiples of 8 already, so ``b`` is copied
    only for odd gathered tiles or dims).
    """
    m, k = a.shape
    n = b.shape[0]
    pk, pn = -k % 8, -n % 8
    pm = max(0, 17 - m)
    if pk or pm:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n] if (pm or pn) else out


def _dot_scores(queries, codes, scale, compute_dtype):
    """(queries @ dequant(codes).T) with f32 accumulation: [Q, N]."""
    if codes.dtype == torch.int8:
        # int8 codes: queries quantized per row on the fly, both scales
        # fold into the f32 epilogue (the reference's int8 path)
        qi, qscale = quantize_queries_i8(queries)
        dots = int8_dot(qi, codes).to(torch.float32) * qscale
    elif compute_dtype == torch.float32:
        dots = queries @ codes.to(torch.float32).t()
    elif queries.is_cuda:
        # operands rounded to compute_dtype, f32 accumulation and result on
        # the tensor cores (aten::mm.dtype, which has no CPU kernel): one
        # 512 x 1,048,576 x 768 product of f8 codes took 4.0 ms this way
        # and 21.3 ms widened to f32 (chip_smoke.py phase 7; NVIDIA H100
        # 80GB HBM3, 700 W)
        dots = torch.mm(queries.to(compute_dtype), codes.to(compute_dtype).t(),
                        out_dtype=torch.float32)
    else:
        # operands rounded to compute_dtype, products summed in f32 (exact
        # products of bf16 values)
        dots = (queries.to(compute_dtype).to(torch.float32)
                @ codes.to(compute_dtype).to(torch.float32).t())
    if scale is not None:
        dots = dots * scale.reshape(1, -1)
    return dots


def _manhattan(queries, codes, scale, row_chunk: int = 2048):
    """Chunked sum|q - v|: bounds the [Q, chunk, D] transient."""
    outs = []
    for start in range(0, codes.shape[0], row_chunk):
        c = codes[start:start + row_chunk].to(torch.float32)
        if scale is not None:
            c = c * scale[start:start + row_chunk]
        outs.append((queries[:, None, :] - c[None, :, :]).abs().sum(dim=-1))
    return torch.cat(outs, dim=1)


def scan_distances(
    queries,
    codes,
    scale=None,
    sqnorm=None,
    valid=None,
    *,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
):
    """Distances from every query to every stored row: ``[Q, N] float32``.

    queries: [Q, D] float32; codes: [N, D] storage dtype; scale: [N, 1] f32
    or None; sqnorm: [N] f32 squared norms of the *dequantized* rows (required
    for cosine/euclidean); valid: [N] bool tombstone mask (False rows get
    +inf). All on one device.
    """
    metric = Metric.parse(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=codes.device)

    if metric == Metric.MANHATTAN:
        dist = _manhattan(queries, codes, scale)
    else:
        dots = _dot_scores(queries, codes, scale, compute_dtype)
        if metric == Metric.COSINE:
            qn = torch.sqrt((queries * queries).sum(dim=1, keepdim=True))
            vn = torch.sqrt(sqnorm.clamp(min=0.0)).reshape(1, -1)
            dist = 1.0 - dots / (qn * vn).clamp(min=_EPS)
        else:  # squared euclidean, matching the reference SIMD kernel
            qsq = (queries * queries).sum(dim=1, keepdim=True)
            dist = (qsq + sqnorm.reshape(1, -1) - 2.0 * dots).clamp(min=0.0)

    if valid is not None:
        dist = torch.where(valid.reshape(1, -1), dist,
                           torch.full_like(dist, float("inf")))
    return dist


def distance_pair(x, y, metric: Metric = Metric.COSINE) -> torch.Tensor:
    """Single-pair f32 distance (CompareDist parity, core/core.go:841-867):
    a 0-d tensor on ``x``'s device (a CPU tensor for numpy input)."""
    metric = Metric.parse(metric)
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    if metric == Metric.COSINE:
        den = (torch.sqrt(torch.dot(x, x)) * torch.sqrt(torch.dot(y, y))).clamp(min=_EPS)
        return 1.0 - torch.dot(x, y) / den
    if metric == Metric.EUCLIDEAN:
        d = x - y
        return torch.dot(d, d)
    return (x - y).abs().sum()


def pairwise_distance(xs, ys, metric: Metric = Metric.COSINE):
    """[A, D] x [B, D] -> [A, B] float32 distances on raw fp32 vectors."""
    ys = torch.as_tensor(ys, dtype=torch.float32)
    sqn = (ys * ys).sum(dim=1)
    return scan_distances(
        xs, ys, None, sqnorm=sqn, metric=metric, compute_dtype=torch.float32
    )
