"""The flat index and its scans (port of ``coltt_tpu/parallel/dist_search.py``).

:class:`DistributedFlatIndex` is the immutable bulk-ingested FLAT index
that the flagship bench (``coltt_tpu_torch/bench.py``) drives: rows are
quantized once onto one device, padded to a multiple of the fused
kernels' largest chunk (4096 rows; padding rows are masked invalid and
never returned), and searched through

- :func:`sharded_scan_topk`: the plain scan or K1's fused scan, optionally
  followed by a rerank of a ``k * oversample`` shortlist against a
  high-precision copy (``rr_codes``);
- :func:`sharded_unit_i8_topk`: the unit-norm int8 path (K2), whose
  shortlist is masked against ``valid`` and then reranked;
- :func:`sharded_bq_topk`: the Hamming shortlist over packed sign words,
  then a rerank against the high-precision copy when there is one;
- :func:`sharded_pq_topk`: the ADC scan over PQ codes
  (:class:`DistributedPQIndex`);
- :func:`sharded_cflat_topk`: the CFLAT weighted multi-vector scan
  (``store/multivec.py``), blocked over rows.

The JAX ``mesh`` argument becomes a ``torch.device``. Only the
single-device branches are ported: a sequence of several devices (the
``shard_map`` branches and their ``_merge_partials``) raises (ROADMAP
Queue 1, item 7). The plain scan's
selection is exact: the reference's ``approx_recall`` is
``lax.approx_max_k``, which is an exact top-k on the CPU where the
reference is checked, so the port takes no such knob.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from coltt_tpu_torch.ops.bq import bq_encode, bq_scan_neg_topk, hamming_to_neg_cos_dist
from coltt_tpu_torch.ops.distance import Metric, scan_distances
from coltt_tpu_torch.ops.fused_scan import (
    _CHUNK,
    chunk_for,
    fused_scan_neg_topk,
    fused_unit_i8_neg_topk,
    unit_i8_bin_live,
    unit_i8_supports,
)
from coltt_tpu_torch.ops.fused_scan import supports as fused_supports
from coltt_tpu_torch.ops.pq import (
    PQCodebook,
    pq_encode,
    pq_rerank_neg_topk,
    pq_scan_neg_topk,
    train_pq,
)
from coltt_tpu_torch.ops.quant import Quantization, dequantize, quantize
from coltt_tpu_torch.ops.score import normalize_score
from coltt_tpu_torch.ops.topk import (
    fetch_scores_ids,
    fit_rows,
    rerank_neg_topk,
    scan_neg_topk,
    scores_from_negd,
    stable_topk,
)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, {item})")


def _one_device(device) -> torch.device:
    """The index's device; several devices are the multi-device path."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            _not_ported("search sharded over several devices",
                        "item 7, multi-device")
        device = device[0]
    return torch.device(device)


def shortlist_scan(queries, codes, scale, sqnorm, valid, *, k, metric,
                   compute_dtype, fused=False, final="auto"):
    """One scan: K1's fused scan, or the plain blocked scan when ``fused``
    is off or the kernel's shape rules do not hold."""
    if fused and fused_supports(codes.shape[0], codes.shape[1], metric,
                                codes.dtype):
        return fused_scan_neg_topk(
            queries, codes, scale, sqnorm, valid,
            k=k, metric=metric, compute_dtype=compute_dtype, final=final,
        )
    return scan_neg_topk(
        queries, codes, scale, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype,
    )


def sharded_scan_topk(
    device,
    codes,
    scale,
    sqnorm,
    valid,
    queries,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    rr_codes=None,
    oversample: int = 8,
    fused: bool = False,
    final: str = "auto",
    pq_rerank=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the index's rows on ``device``: ``(scores [Q, k] on the
    0-100 scale, ids [Q, k])``.

    ``rr_codes`` enables the rerank: the scan shortlists
    ``k * oversample`` rows, which are re-scored against ``rr_codes``.
    ``pq_rerank = (pqcodes, centroids, coarse)`` (exclusive with
    ``rr_codes``) is the PQ-cache serving shape instead: the shortlist
    from the f8 reconstruction cache in ``codes`` is re-scored against the
    exact reconstruction of its code rows (queries already rotated).
    ``fused=True`` scans through K1 (``ops/fused_scan.py``) where its
    shape rules hold.
    """
    _one_device(device)
    metric = Metric.parse(metric)
    if pq_rerank is not None and rr_codes is not None:
        raise ValueError("pq_rerank and rr_codes are mutually exclusive")
    kw = dict(metric=metric, compute_dtype=compute_dtype, fused=fused,
              final=final)
    if rr_codes is None and pq_rerank is None:
        negd, ids = shortlist_scan(queries, codes, scale, sqnorm, valid, k=k, **kw)
        return scores_from_negd(negd, metric), ids
    shortlist = min(max(k * oversample, k), codes.shape[0])
    negd, ids = shortlist_scan(queries, codes, scale, sqnorm, valid, k=shortlist, **kw)
    if pq_rerank is not None:
        pqcodes, centroids, coarse = pq_rerank
        negd, ids = pq_rerank_neg_topk(
            queries, negd, ids, pqcodes, centroids,
            k=min(k, negd.shape[1]), metric=metric, coarse=coarse,
        )
    else:
        negd, ids = rerank_neg_topk(
            queries, negd, ids, rr_codes,
            k=k, metric=metric, compute_dtype=compute_dtype,
        )
    return scores_from_negd(negd, metric), ids


def _unit_shortlist(codes, gscale, bin_live, valid, queries, *, k, oversample):
    """K2's shortlist with rows that are not valid set to -inf. K2 masks
    only bins without any valid row, so a padding row sharing a live bin
    can win it (its zero code dots to 0, above every negative cosine)."""
    shortlist = min(max(k * oversample, k), codes.shape[0])
    negd, ids = fused_unit_i8_neg_topk(
        queries, codes, gscale, bin_live, k=shortlist,
    )
    ok = (ids >= 0) & valid[ids.clamp(min=0).long()]
    return torch.where(ok, negd, -float("inf")), ids


def sharded_unit_i8_topk(
    device,
    codes,
    gscale,
    bin_live,
    valid,
    rr_codes,
    queries,
    *,
    k: int,
    oversample: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine top-k over unit-norm, global-scale int8 codes on ``device``:
    K2's shortlist (selection "auto": slot2 above 8192 bins), the
    valid-row mask, then a bf16 rerank. Returns ``(scores [Q, k] 0-100,
    ids [Q, k])``."""
    _one_device(device)
    negd, ids = _unit_shortlist(codes, gscale, bin_live, valid, queries,
                                k=k, oversample=oversample)
    negd, ids = rerank_neg_topk(
        queries, negd, ids, rr_codes,
        k=k, metric=Metric.COSINE, compute_dtype=torch.bfloat16,
    )
    return scores_from_negd(negd, Metric.COSINE), ids


def sharded_bq_topk(
    device,
    codes,
    valid,
    rr_codes,
    queries,
    *,
    k: int,
    oversample: int = 8,
    dim: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine top-k over binary (BQ) codes on ``device``: queries are
    sign-packed once, a Hamming shortlist of ``k * oversample`` rows is
    taken, then reranked against ``rr_codes`` (bf16 operands) when there
    is a copy. Without one the Hamming values are the final ranking: the
    selection is exact per block and the score is the angle estimate.
    Returns ``(scores [Q, k] 0-100, ids [Q, k])``."""
    _one_device(device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=codes.device)
    shortlist = min(max(k * oversample, k), codes.shape[0])
    negh, ids = bq_scan_neg_topk(bq_encode(queries), codes, valid, k=shortlist,
                                 exact=rr_codes is None)
    kk = min(k, negh.shape[1])
    if rr_codes is not None:
        negd, ids = rerank_neg_topk(
            queries, negh, ids, rr_codes, k=kk, metric=Metric.COSINE,
            compute_dtype=torch.bfloat16,
        )
    else:
        negd, ids = hamming_to_neg_cos_dist(negh[:, :kk], dim), ids[:, :kk]
    return scores_from_negd(negd, Metric.COSINE), ids


def sharded_pq_topk(
    device,
    codes,
    centroids,
    sqnorm,
    valid,
    queries,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    rotation=None,
    coarse=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over PQ codes on ``device`` (the blocked ADC scan); the OPQ
    ``rotation`` is applied to the queries once. Returns ``(scores [Q, k]
    0-100, ids [Q, k])``."""
    _one_device(device)
    metric = Metric.parse(metric)
    negd, ids = pq_scan_neg_topk(
        queries, codes, centroids, sqnorm, valid, k=k, metric=metric,
        compute_dtype=compute_dtype, rotation=rotation, coarse=coarse,
    )
    return scores_from_negd(negd, metric), ids


def _cflat_scores(field_state, queries, ratios, valid, *, metric, compute_dtype):
    """Batched CFLAT scoring: sum_f ratio_f * normalize(dist_f) -> [Q, N],
    rows that are not valid at -inf. Fields are summed in their order, as
    the reference does."""
    total = None
    for (codes, scale, sqnorm), q, r in zip(field_state, queries, ratios):
        dist = scan_distances(q, codes, scale, sqnorm, None, metric=metric,
                              compute_dtype=compute_dtype)
        contrib = normalize_score(dist, metric) * r
        total = contrib if total is None else total + contrib
    return torch.where(valid.reshape(1, -1), total, -float("inf"))


# f32 [Q, rows] tensors alive at once in a CFLAT block: the dots, the
# epilogue's temporaries, the field's contribution and the running sum
_CFLAT_LIVE = 6


def sharded_cflat_topk(
    device,
    field_state,   # tuple of (codes [N, Df], scale [N, 1] | None, sqnorm [N])
    valid,
    queries,       # tuple of [Q, Df] f32, parallel to field_state
    ratios,        # tuple of floats (already / 100)
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    block_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CFLAT weighted multi-vector search on ``device``: ``(scores [Q, kk],
    ids [Q, kk])``, kk = min(k, N), scores the 0-100 weighted sums.

    The reference scores all N rows of every field into one [Q, N] matrix
    and takes one ``lax.top_k``. Here the rows go in blocks sized from
    the free device memory (``block_rows`` overrides): each block's
    weighted sum over the fields keeps its exact top-k, and the blocks'
    candidates, laid out in slot order, are merged by one more exact
    selection. Every keep settles the tie group at its cut, so equal
    scores come out lower slot first, as from ``lax.top_k`` (a euclidean
    score clips at 0, and on most data every far row ties there). Rows
    that are not valid score -inf."""
    _one_device(device)
    metric = Metric.parse(metric)
    # each ratio rounded to f32 once, as the reference's jnp.float32
    ratios = tuple(float(np.float32(r)) for r in ratios)
    n = valid.shape[0]
    kk = min(k, n)
    q = queries[0].shape[0]
    width = max(codes.shape[1] for codes, _, _ in field_state)
    # plus each block row's bf16 and f32 copies of its widest code row
    block = block_rows or fit_rows(n, q * 4 * _CFLAT_LIVE + width * 6, valid.device)
    vals, ids = [], []
    for start in range(0, n, block):
        stop = min(n, start + block)
        part = tuple(
            (codes[start:stop], None if scale is None else scale[start:stop],
             sqnorm[start:stop])
            for codes, scale, sqnorm in field_state)
        total = _cflat_scores(part, queries, ratios, valid[start:stop],
                              metric=metric, compute_dtype=compute_dtype)
        v, i = stable_topk(total, min(kk, stop - start))
        vals.append(v)
        ids.append(i + start)
    if len(vals) == 1:
        return vals[0], ids[0].to(torch.int32)
    # block-major candidates, each block's in slot order among equal
    # scores: the exact merge ranks equal scores lower slot first
    scores, sel = stable_topk(torch.cat(vals, dim=1), kk)
    return scores, torch.gather(torch.cat(ids, dim=1), 1, sel).to(torch.int32)


class DistributedFlatIndex:
    """An immutable FLAT index on one device, for serving benchmarks.
    Ingest quantizes once; :meth:`search` runs the scans above. Mutable
    serving uses ``store/flat.py``'s FlatStore.

    ``quantization`` is NONE, a dense codec (F16, BF16, F8, I8) or BQ
    (packed sign words, cosine only; :meth:`from_bq_codes` adopts words
    packed elsewhere); ``rerank_dtype`` (e.g. ``torch.bfloat16``) keeps a
    high-precision copy for the rerank; ``unit_i8=True`` stores unit-norm
    rows under one global int8 scale for K2 (cosine only, needs
    ``rerank_dtype``).
    """

    def __init__(
        self,
        device,
        vectors,
        *,
        metric: Metric = Metric.COSINE,
        quantization: Quantization = Quantization.NONE,
        compute_dtype=None,
        rerank_dtype=None,
        unit_i8: bool = False,
    ):
        self._configure(device, metric, quantization, compute_dtype,
                        rerank_dtype, unit_i8)
        n, dim = vectors.shape
        if self.unit_i8 and (rerank_dtype is None
                             or not unit_i8_supports(0, dim, self.metric)):
            raise ValueError(
                "unit_i8 needs metric=cosine, dim % 128 == 0, dim <= 2048, "
                "and a rerank_dtype")
        if self.quantization == Quantization.BQ and self.metric != Metric.COSINE:
            raise ValueError("BQ is cosine-only")
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        # pad to a multiple of the fused kernels' largest chunk; padding
        # rows are masked invalid and never returned
        pad = (-n) % (2 * _CHUNK)
        if pad:
            vectors = torch.cat([vectors, vectors.new_zeros((pad, dim))])
        self.n = n
        self.dim = dim
        valid = torch.arange(vectors.shape[0], device=self.device) < n

        self.gscale = self.bin_live = None
        if self.quantization == Quantization.BQ:
            # [N, ceil(D/32)] sign words; padding rows are zero words
            # masked by ``valid``
            self.codes = bq_encode(vectors)
            self.scale = self.sqnorm = None
        elif self.unit_i8:
            # unit-norm rows, ONE global scale: ranking is the raw int dot
            norms = torch.linalg.vector_norm(vectors, dim=1, keepdim=True)
            un = vectors / norms.clamp(min=1e-30)
            gmax = un.abs().amax()
            self.gscale = torch.where(gmax > 0, gmax / 127.0,
                                      torch.ones_like(gmax))
            self.codes = torch.round(un / self.gscale).clamp(-127, 127).to(
                torch.int8)
            del un
            self.bin_live = unit_i8_bin_live(valid, chunk_for(vectors.shape[0]))
            self.scale = self.sqnorm = None
        else:
            self.codes, self.scale = quantize(vectors, self.quantization)
            deq = dequantize(self.codes, self.scale)
            self.sqnorm = (deq * deq).sum(dim=1)
            del deq
        self.valid = valid
        self.rr_codes = (vectors.to(rerank_dtype)
                         if rerank_dtype is not None else None)

    def _configure(self, device, metric, quantization, compute_dtype,
                   rerank_dtype, unit_i8):
        """The settings an index holds besides its arrays; ingest and
        ``parallel/convert.py`` both start here."""
        self.device = _one_device(device)
        self.metric = Metric.parse(metric)
        self.quantization = Quantization.parse(quantization)
        self.rerank_dtype = rerank_dtype
        if compute_dtype is None:
            compute_dtype = (torch.float32
                             if self.quantization == Quantization.NONE
                             else torch.bfloat16)
        self.compute_dtype = compute_dtype
        self.unit_i8 = bool(unit_i8)

    @classmethod
    def from_bq_codes(
        cls,
        device,
        packed,
        *,
        dim: int,
        rr_codes=None,
        rerank_dtype=torch.bfloat16,
    ) -> "DistributedFlatIndex":
        """A BQ index from pre-packed sign words ``[N, ceil(dim/32)]``
        (numpy uint32 / int32 or a tensor): the ingest path for corpora
        packed slab by slab with ``bq_encode``. ``rr_codes [N, dim]`` (any
        float numpy array or tensor) becomes the ``rerank_dtype`` copy.
        Rows are padded to a multiple of 4096, masked invalid."""
        self = cls.__new__(cls)
        self._configure(device, Metric.COSINE, Quantization.BQ, torch.bfloat16,
                        rerank_dtype if rr_codes is not None else None, False)
        if not torch.is_tensor(packed):
            packed = torch.from_numpy(np.array(packed).view(np.int32))
        n, w = packed.shape
        self.n, self.dim = n, dim
        pad = (-n) % (2 * _CHUNK)
        self.codes = torch.cat([packed.to(self.device),
                                packed.new_zeros((pad, w)).to(self.device)])
        self.valid = torch.arange(n + pad, device=self.device) < n
        self.scale = self.sqnorm = self.gscale = self.bin_live = None
        self.rr_codes = None
        if rr_codes is not None:
            rr = torch.as_tensor(rr_codes).to(self.device).to(rerank_dtype)
            self.rr_codes = torch.cat([rr, rr.new_zeros((pad, dim))])
        return self

    def search_tensors(
        self, queries: torch.Tensor, k: int, *, oversample: int = 8,
        fused: bool = False, final: str = "auto",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` on a ``[Q, D]`` f32 tensor on the index's device,
        returning device tensors ``(scores, ids)`` without waiting for the
        device (the bench queues batches through this). ``fused`` and
        ``final`` choose the scan of a non-unit_i8 index; a unit_i8 index
        always runs K2 with its own selection, as in the reference; a BQ
        index its Hamming shortlist (``fused`` and ``final`` unused)."""
        if self.quantization == Quantization.BQ:
            return sharded_bq_topk(
                self.device, self.codes, self.valid, self.rr_codes, queries,
                k=k, oversample=oversample, dim=self.dim,
            )
        if self.unit_i8:
            return sharded_unit_i8_topk(
                self.device, self.codes, self.gscale, self.bin_live,
                self.valid, self.rr_codes, queries, k=k, oversample=oversample,
            )
        return sharded_scan_topk(
            self.device, self.codes, self.scale, self.sqnorm, self.valid,
            queries, k=k, metric=self.metric, compute_dtype=self.compute_dtype,
            rr_codes=self.rr_codes, oversample=oversample, fused=fused,
            final=final,
        )

    def search(
        self, queries, k: int, *, oversample: int = 8, fused: bool = False,
        final: str = "auto",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k of each query: host ``(scores [Q, k] 0-100, ids [Q, k])``;
        an empty slot has score -inf and id -1."""
        queries = torch.as_tensor(
            np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        scores, ids = self.search_tensors(queries, k, oversample=oversample,
                                          fused=fused, final=final)
        scores, ids = fetch_scores_ids(scores, ids)
        ids = np.where(np.isneginf(scores), -1, ids)
        return scores, ids



class DistributedPQIndex:
    """A PQ index on one device: train once (sampled) unless a codebook is
    given, encode, serve ADC scans. PQ codes at M = dim/8 are one byte
    per 8 floats."""

    def __init__(
        self,
        device,
        vectors,
        *,
        metric: Metric = Metric.COSINE,
        codebook: Optional[PQCodebook] = None,
        m: Optional[int] = None,
        train_sample: int = 65_536,
        compute_dtype=torch.bfloat16,
        opq_iters: int = 0,
    ):
        self.device = _one_device(device)
        self.metric = Metric.parse(metric)
        self.compute_dtype = compute_dtype
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        self.n, self.dim = vectors.shape
        if codebook is None:
            codebook = train_pq(vectors, m=m, sample_size=train_sample,
                                opq_iters=opq_iters)
        self.codebook = codebook.to(self.device)
        self.codes, self.sqnorm = pq_encode(vectors, self.codebook)
        self.valid = torch.ones(self.n, dtype=torch.bool, device=self.device)

    def search_tensors(self, queries: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` on a ``[Q, D]`` f32 tensor on the index's device,
        returning device tensors ``(scores, ids)``."""
        return sharded_pq_topk(
            self.device, self.codes, self.codebook.centroids, self.sqnorm,
            self.valid, queries, k=k, metric=self.metric,
            compute_dtype=self.compute_dtype, rotation=self.codebook.rotation,
            coarse=self.codebook.coarse,
        )

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k of each query: host ``(scores [Q, k] 0-100, ids [Q, k])``;
        an empty slot has score -inf and id -1."""
        queries = torch.as_tensor(
            np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        scores, ids = fetch_scores_ids(*self.search_tensors(queries, k))
        return scores, np.where(np.isneginf(scores), -1, ids)
