"""The flat index and its sharded scans (port of
``coltt_tpu/parallel/dist_search.py``).

:class:`DistributedFlatIndex` is the immutable bulk-ingested FLAT index
that the flagship bench (``coltt_tpu_torch/bench.py``) drives: rows are
quantized once, padded so that every shard's rows are a multiple of the
fused kernels' largest chunk (4096 rows; padding rows are masked invalid
and never returned), and searched through

- :func:`sharded_scan_topk`: the plain scan or K1's fused scan, optionally
  followed by a rerank of a ``k * oversample`` shortlist against a
  high-precision copy (``rr_codes``) or, for the PQ cache, against the
  exact reconstruction of the shortlist's code rows (``pq_rerank``);
- :func:`sharded_unit_i8_topk`: the unit-norm int8 path (K2), whose
  shortlist is masked against ``valid`` and then reranked;
- :func:`sharded_bq_topk`: the Hamming shortlist over packed sign words,
  then a rerank against the high-precision copy when there is one;
- :func:`sharded_pq_topk`: the ADC scan over PQ codes
  (:class:`DistributedPQIndex`);
- :func:`sharded_cflat_topk`: the CFLAT weighted multi-vector scan
  (``store/multivec.py``), blocked over rows.

Each takes, where the reference takes its ``Mesh``, either a
``torch.device`` (everything on one device) or a
:class:`~coltt_tpu_torch.parallel.mesh.Mesh`. On a mesh the row arrays are
:class:`~coltt_tpu_torch.parallel.mesh.ShardedRows` (a tensor is cut on
the fly) and the reference's ``shard_map`` body runs once per shard on
the shard's device, queries split over the batch axis: each shard keeps
its local top-k (ranked on raw negated distance, so euclidean's clipped
score cannot tie far rows), reranks it locally, and
:func:`_merge_partials` merges the ``[Q, k]`` partials shard-major by
``stable_topk``, which gives ``lax.top_k``'s order over the reference's
tiled ``all_gather``: among equal values the lower global id first. No
shard waits for the device, so the shards of several cards overlap; the
one wait is the caller's fetch. A one-device mesh takes the one-device
path unless ``bypass_single=False`` (``sharded_scan_topk`` only, as in
the reference). A multi-process mesh (``parallel/multihost.py``) merges
each process's partials once more across processes.

The plain scan's selection is exact: the reference's ``approx_recall`` is
``lax.approx_max_k``, an exact top-k on the CPU where the reference is
checked, so the port takes no such knob.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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
    pq_rescore_rows,
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
from coltt_tpu_torch.parallel.mesh import Mesh, ShardedRows, on_device, replicate, split
from coltt_tpu_torch.parallel.multihost import max_across_processes, merge_across_processes


# -- the shard loop and the merge ------------------------------------------------

def _single(mesh, bypass: bool = True) -> bool:
    """Whether a call runs the one-device path: a device, or a one-device
    mesh of one process when the bypass is on."""
    return not isinstance(mesh, Mesh) or (
        bypass and mesh.size == 1 and not mesh.distributed)


def _local(x):
    """A one-device argument: a one-shard ShardedRows' block, a replica
    dict's only tensor, or ``x`` itself."""
    if isinstance(x, ShardedRows):
        return x.shard(0)
    if isinstance(x, dict):
        return next(iter(x.values()))
    return x


def _rows(mesh: Mesh, x):
    """``x`` as rows sharded over ``mesh`` (None stays None)."""
    if x is None or isinstance(x, ShardedRows):
        return x
    return ShardedRows.place(mesh, x)


def _on(x, dev: torch.device):
    """A replicated argument on ``dev``: a ``{device: tensor}`` replica
    dict's entry, or the tensor copied (None stays None)."""
    if x is None:
        return None
    return x[dev] if isinstance(x, dict) else x.to(dev)


def _merge_partials(parts, local_n: int, k: int, dst: torch.device,
                    shard_offset: int = 0):
    """The collective tail: localize each shard's ids by ``shard_index *
    local_n`` (``local_n`` the padded rows per shard), copy the partials to
    ``dst`` without waiting, concatenate them shard-major and take the
    stable top-k, so that equal values rank the lower global id first, as
    the reference's ``lax.top_k`` over its tiled ``all_gather``."""
    vals, ids = [], []
    for s, (negd, i) in enumerate(parts):
        gid = i.to(torch.int64) + (shard_offset + s) * local_n
        vals.append(negd.to(dst, non_blocking=True))
        ids.append(gid.to(dst, non_blocking=True))
    all_negd, all_ids = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
    mneg, sel = stable_topk(all_negd, min(k, all_negd.shape[1]))
    return mneg, torch.gather(all_ids, 1, sel)


def _shard_search(mesh: Mesh, queries: Sequence[torch.Tensor], local_n: int,
                  k: int, body: Callable, finish: Optional[Callable] = None):
    """The ``shard_map`` of the reference: ``body(s, b, queries)`` -> the
    local ``(negd, ids)`` of local shard ``s`` on its device
    ``mesh.devices[s][b]`` for batch column ``b``'s queries (each of
    ``queries`` is padded to a multiple of the batch axis and split over
    it). Every body is queued before any ``finish(s, b, queries,
    partial)`` runs, so a finish that
    waits for the device (the host PQ gather) finds every shard's scan
    already queued. Each column's partials merge on its first device;
    the columns are joined on ``mesh.device`` and, on a multi-process
    mesh, merged across processes. Returns ``(negd [Q, kk], global ids
    [Q, kk] int32)``."""
    q = queries[0].shape[0]
    per = -(-q // mesh.batch)
    padded = [x if x.shape[0] == per * mesh.batch else
              torch.cat([x, x.new_zeros((per * mesh.batch - q, *x.shape[1:]))])
              for x in queries]
    cols = []
    for b in range(mesh.batch):
        parts = []
        for s in range(mesh.local_shards):
            dev = mesh.devices[s][b]
            qs = tuple(x[b * per:(b + 1) * per].to(dev) for x in padded)
            with on_device(dev):
                parts.append((qs, body(s, b, qs)))
        if finish is not None:
            for s, (qs, part) in enumerate(parts):
                with on_device(mesh.devices[s][b]):
                    parts[s] = (qs, finish(s, b, qs, part))
        cols.append(_merge_partials([p for _, p in parts], local_n, k,
                                    mesh.devices[0][b], mesh.shard_offset))
    negd = torch.cat([v.to(mesh.device) for v, _ in cols])[:q]
    ids = torch.cat([i.to(mesh.device) for _, i in cols])[:q]
    if mesh.distributed:
        negd, ids = merge_across_processes(negd, ids, k)
    return negd, ids.to(torch.int32)


# -- the scans -------------------------------------------------------------------

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
    mesh,
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
    bypass_single: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the rows on ``mesh`` (a device or a Mesh): ``(scores
    [Q, k] on the 0-100 scale, global ids [Q, k])``.

    ``rr_codes`` (sharded like ``codes``) enables the rerank: each shard
    shortlists ``k * oversample`` rows and re-scores them against
    ``rr_codes`` before the merge, so the gathers stay shard-local.
    ``pq_rerank = (pqcodes, centroids, coarse)`` (exclusive with
    ``rr_codes``) is the PQ-cache serving shape instead: the shortlist
    from the f8 reconstruction cache in ``codes`` is re-scored against the
    exact reconstruction of its code rows (queries already rotated), shard
    by shard. ``pqcodes`` may be a host numpy table of every row (the
    host-codes mode): each shard's shortlist rows are gathered there and
    uploaded. ``fused=True`` scans through K1 (``ops/fused_scan.py``)
    where its shape rules hold: on a mesh, once per shard; ``final``
    selects its bin survivors in every shard branch, one of
    ``fused_scan.FINALS`` (``auto``, ``exact``, ``approx``, ``approx2``,
    ``slot2``, ``slot2t``, ``slot2c``, ``slot2a``).
    ``bypass_single=False`` runs the shard body and merge even on a
    one-device mesh."""
    metric = Metric.parse(metric)
    if pq_rerank is not None and rr_codes is not None:
        raise ValueError("pq_rerank and rr_codes are mutually exclusive")
    kw = dict(metric=metric, compute_dtype=compute_dtype, fused=fused,
              final=final)
    pqcodes, centroids, coarse = pq_rerank if pq_rerank is not None else (None,) * 3
    host_pq = isinstance(pqcodes, np.ndarray)

    def body(q, c, sc, sq, v, rr, pqc, cent, co):
        if rr is None and pq_rerank is None:
            return shortlist_scan(q, c, sc, sq, v, k=k, **kw)
        shortlist = min(max(k * oversample, k), c.shape[0])
        negd, ids = shortlist_scan(q, c, sc, sq, v, k=shortlist, **kw)
        if rr is not None:
            return rerank_neg_topk(q, negd, ids, rr, k=k, metric=metric,
                                   compute_dtype=compute_dtype)
        if host_pq:
            return negd, ids  # finished by host_rerank
        return pq_rerank_neg_topk(q, negd, ids, pqc, cent,
                                  k=min(k, negd.shape[1]), metric=metric, coarse=co)

    def host_rerank(q, negd, ids, offset, cent, co):
        """The host-codes rerank: the shortlist's code rows gathered from
        the host table (global rows ``offset + id``) and uploaded."""
        ih = ids.cpu().numpy()
        crow = torch.from_numpy(
            pqcodes[np.where(ih >= 0, ih, 0).reshape(-1) + offset]).to(negd.device)
        return pq_rescore_rows(q, negd, ids, crow, cent, k=min(k, negd.shape[1]),
                               metric=metric, coarse=co)

    if _single(mesh, bypass_single):
        cent, co = _local(centroids), _local(coarse)
        negd, ids = body(queries, *map(_local, (codes, scale, sqnorm, valid, rr_codes,
                                                pqcodes)), cent, co)
        if host_pq:
            negd, ids = host_rerank(queries, negd, ids, 0, cent, co)
        return scores_from_negd(negd, metric), ids

    codes, scale, sqnorm, valid, rr_codes = (
        _rows(mesh, x) for x in (codes, scale, sqnorm, valid, rr_codes))
    if pqcodes is not None and not host_pq:
        pqcodes = _rows(mesh, pqcodes)
    local_n = codes.local_n

    def shard_body(s, b, qs):
        dev = mesh.devices[s][b]
        blk = (None if x is None else x.shard(s, b)
               for x in (codes, scale, sqnorm, valid, rr_codes,
                         None if host_pq else pqcodes))
        return body(qs[0], *blk, _on(centroids, dev), _on(coarse, dev))

    def shard_finish(s, b, qs, part):
        dev = mesh.devices[s][b]
        offset = (mesh.shard_offset + s) * local_n
        return host_rerank(qs[0], *part, offset, _on(centroids, dev), _on(coarse, dev))

    negd, ids = _shard_search(mesh, (queries,), local_n, k, shard_body,
                              shard_finish if host_pq else None)
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
    mesh,
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
    """Cosine top-k over unit-norm, global-scale int8 codes: K2's
    shortlist (selection "auto": slot2 above 8192 bins), the valid-row
    mask, then a bf16 rerank, per shard before the merge. ``gscale`` is
    the one scale of every row, so the shards' raw s32 dots rank on one
    scale. Returns ``(scores [Q, k] 0-100, ids [Q, k])``."""
    def body(q, c, g, bl, v, rr):
        negd, ids = _unit_shortlist(c, g, bl, v, q, k=k, oversample=oversample)
        return rerank_neg_topk(q, negd, ids, rr, k=k, metric=Metric.COSINE,
                               compute_dtype=torch.bfloat16)

    if _single(mesh):
        negd, ids = body(queries, _local(codes), _local(gscale), _local(bin_live),
                         _local(valid), _local(rr_codes))
        return scores_from_negd(negd, Metric.COSINE), ids
    codes, bin_live, valid, rr_codes = (
        _rows(mesh, x) for x in (codes, bin_live, valid, rr_codes))

    def shard_body(s, b, qs):
        return body(qs[0], codes.shard(s, b), _on(gscale, mesh.devices[s][b]),
                    bin_live.shard(s, b), valid.shard(s, b), rr_codes.shard(s, b))

    negd, ids = _shard_search(mesh, (queries,), codes.local_n, k, shard_body)
    return scores_from_negd(negd, Metric.COSINE), ids


def bq_shortlist_topk(queries, packed, codes, valid, rr_codes, rr_scale, *, k,
                      oversample, dim, compute_dtype=torch.bfloat16, rows=None):
    """One device's BQ top-k: a Hamming shortlist of ``k * oversample``
    rows, reranked against ``rr_codes`` (``rr_scale`` an f8 copy's per-row
    scale) when there is a copy, else the Hamming values as the angle
    estimate under an exact per-block selection. ``rows`` (optional) names
    the store rows that ``codes`` / ``valid`` hold (a gathered candidate
    set); the ids, and the rerank's gathers, are then store rows. Returns
    ``(negd [Q, kk], ids [Q, kk])``."""
    shortlist = min(max(k * oversample, k), codes.shape[0])
    negh, ids = bq_scan_neg_topk(packed, codes, valid, k=shortlist,
                                 exact=rr_codes is None)
    if rows is not None:
        ids = rows[ids.long()]
    kk = min(k, negh.shape[1])
    if rr_codes is not None:
        return rerank_neg_topk(queries, negh, ids, rr_codes, k=kk,
                               metric=Metric.COSINE, compute_dtype=compute_dtype,
                               rr_scale=rr_scale)
    return hamming_to_neg_cos_dist(negh[:, :kk], dim), ids[:, :kk]


def sharded_bq_topk(
    mesh,
    codes,
    valid,
    rr_codes,
    queries,
    *,
    k: int,
    oversample: int = 8,
    dim: int,
    rr_scale=None,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine top-k over binary (BQ) codes: queries are sign-packed once,
    and each shard runs :func:`bq_shortlist_topk` on its rows (the
    rerank's operands ``compute_dtype``). Without a rerank copy the Hamming
    values are the final ranking, comparable across shards (same dim).
    Returns ``(scores [Q, k] 0-100, ids [Q, k])``."""
    queries = torch.as_tensor(queries, dtype=torch.float32, device=split(mesh).device)
    packed = bq_encode(queries)
    kw = dict(k=k, oversample=oversample, dim=dim, compute_dtype=compute_dtype)

    if _single(mesh):
        negd, ids = bq_shortlist_topk(
            queries, packed, *map(_local, (codes, valid, rr_codes, rr_scale)), **kw)
        return scores_from_negd(negd, Metric.COSINE), ids
    codes, valid, rr_codes, rr_scale = (
        _rows(mesh, x) for x in (codes, valid, rr_codes, rr_scale))

    def shard_body(s, b, qs):
        return bq_shortlist_topk(qs[0], qs[1], *(
            None if x is None else x.shard(s, b)
            for x in (codes, valid, rr_codes, rr_scale)), **kw)

    negd, ids = _shard_search(mesh, (queries, packed), codes.local_n, k, shard_body)
    return scores_from_negd(negd, Metric.COSINE), ids


def sharded_pq_topk(
    mesh,
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
    """Top-k over PQ codes (the blocked ADC scan, per shard); the codebook
    is replicated and the OPQ ``rotation`` is applied to the queries once,
    up front. Returns ``(scores [Q, k] 0-100, ids [Q, k])``."""
    metric = Metric.parse(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=split(mesh).device)
    if rotation is not None:
        queries = queries @ _on(rotation, queries.device)

    def body(q, c, cent, sq, v, co):
        return pq_scan_neg_topk(q, c, cent, sq, v, k=k, metric=metric,
                                compute_dtype=compute_dtype, coarse=co)

    if _single(mesh):
        negd, ids = body(queries, *map(_local, (codes, centroids, sqnorm, valid,
                                                coarse)))
        return scores_from_negd(negd, metric), ids
    codes, sqnorm, valid = (_rows(mesh, x) for x in (codes, sqnorm, valid))

    def shard_body(s, b, qs):
        dev = mesh.devices[s][b]
        return body(qs[0], codes.shard(s, b), _on(centroids, dev),
                    sqnorm.shard(s, b), valid.shard(s, b), _on(coarse, dev))

    negd, ids = _shard_search(mesh, (queries,), codes.local_n, k, shard_body)
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


def _cflat_topk(field_state, valid, queries, ratios, *, k, metric,
                compute_dtype, block_rows):
    """CFLAT top-k over rows on one device, blocked over rows by free
    memory: ``(scores [Q, kk], ids [Q, kk] int32)``, kk = min(k, N)."""
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


def sharded_cflat_topk(
    mesh,
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
    """CFLAT weighted multi-vector search: ``(scores [Q, kk], ids [Q,
    kk])``, kk = min(k, N), scores the 0-100 weighted sums.

    The reference scores all N rows of every field into one [Q, N] matrix
    and takes one ``lax.top_k`` (per shard on a mesh, then the merge).
    Here a device's rows go in blocks sized from its free memory
    (``block_rows`` overrides): each block's weighted sum over the fields
    keeps its exact top-k, and the blocks' candidates, laid out in slot
    order, are merged by one more exact selection, then the shards'
    partials by :func:`_merge_partials`. Every keep settles the tie group
    at its cut, so equal scores come out lower slot first, as from
    ``lax.top_k`` (a euclidean score clips at 0, and on most data every
    far row ties there). Rows that are not valid score -inf."""
    metric = Metric.parse(metric)
    # each ratio rounded to f32 once, as the reference's jnp.float32
    ratios = tuple(float(np.float32(r)) for r in ratios)
    kw = dict(k=k, metric=metric, compute_dtype=compute_dtype,
              block_rows=block_rows)
    if _single(mesh):
        state = tuple(tuple(map(_local, f)) for f in field_state)
        return _cflat_topk(state, _local(valid), queries, ratios, **kw)
    state = tuple(tuple(_rows(mesh, x) for x in f) for f in field_state)
    valid = _rows(mesh, valid)

    def shard_body(s, b, qs):
        part = tuple(tuple(None if x is None else x.shard(s, b) for x in f)
                     for f in state)
        return _cflat_topk(part, valid.shard(s, b), qs, ratios, **kw)

    return _shard_search(mesh, tuple(queries), valid.local_n, k, shard_body)


# -- the indexes -------------------------------------------------------------------

class DistributedFlatIndex:
    """An immutable FLAT index for serving benchmarks: on one device, or
    row-sharded over a :class:`Mesh`. Ingest quantizes once (each shard's
    rows on its own device); :meth:`search` runs the scans above. Mutable
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
        vectors = torch.as_tensor(vectors, dtype=torch.float32)
        if self.mesh is None:
            vectors = vectors.to(self.device)
        self.n = n
        self.dim = dim
        # pad so that every shard's rows are a multiple of the fused
        # kernels' largest chunk; padding rows are masked invalid and never
        # returned
        total = n + (-n) % (self._shards * 2 * _CHUNK)

        def rows(lo, hi, d):
            """Global rows [lo, hi) on ``d``, zero rows past ``n``."""
            x = vectors[lo:min(hi, n)].to(d)
            if x.shape[0] < hi - lo:
                x = torch.cat([x, x.new_zeros((hi - lo - x.shape[0], dim))])
            return x

        def unit(lo, hi, d):
            x = rows(lo, hi, d)
            return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-30)

        self.gscale = None
        if self.unit_i8:
            # unit-norm rows, ONE global scale: ranking is the raw int dot;
            # the scale's max runs over every shard's rows
            gmax = self._max_over_shards(total, lambda lo, hi, d: unit(lo, hi, d).abs().amax())
            self.gscale = torch.where(gmax > 0, gmax / 127.0, torch.ones_like(gmax))

        def encode(lo, hi, d):
            x = rows(lo, hi, d)
            valid = torch.arange(lo, hi, device=d) < n
            out = {"valid": valid}
            if self.quantization == Quantization.BQ:
                # [N, ceil(D/32)] sign words; padding rows are zero words
                # masked by ``valid``
                out["codes"] = bq_encode(x)
            elif self.unit_i8:
                g = self.gscale.to(d)
                out["codes"] = torch.round(unit(lo, hi, d) / g).clamp(-127, 127).to(
                    torch.int8)
                out["bin_live"] = unit_i8_bin_live(valid, chunk_for(hi - lo))
            else:
                out["codes"], out["scale"] = quantize(x, self.quantization)
                deq = dequantize(out["codes"], out["scale"])
                out["sqnorm"] = (deq * deq).sum(dim=1)
            if rerank_dtype is not None:
                out["rr_codes"] = x.to(rerank_dtype)
            return out

        self.scale = self.sqnorm = self.bin_live = self.rr_codes = None
        for name, value in self._encode(total, encode).items():
            setattr(self, name, value)
        if self.mesh is not None and self.gscale is not None:
            self.gscale = replicate(self.mesh, self.gscale)

    def _configure(self, device, metric, quantization, compute_dtype,
                   rerank_dtype, unit_i8):
        """The settings an index holds besides its arrays; ingest and
        ``parallel/convert.py`` both start here. ``device`` is a device or
        a :class:`Mesh`."""
        self.mesh, self.device, self.placement = split(device)
        self._shards = self.mesh.shards if self.mesh else 1
        self.metric = Metric.parse(metric)
        self.quantization = Quantization.parse(quantization)
        self.rerank_dtype = rerank_dtype
        if compute_dtype is None:
            compute_dtype = (torch.float32
                             if self.quantization == Quantization.NONE
                             else torch.bfloat16)
        self.compute_dtype = compute_dtype
        self.unit_i8 = bool(unit_i8)

    def _max_over_shards(self, total: int, fn) -> torch.Tensor:
        """max of ``fn(lo, hi, device)`` over every shard's row range, on
        ``self.device``: this process's shards, then across processes."""
        if self.mesh is None:
            return fn(0, total, self.device)
        local = total // self.mesh.shards
        first = self.mesh.shard_offset
        gmax = torch.stack([
            fn(s * local, (s + 1) * local, self.mesh.devices[s - first][0]).to(self.device)
            for s in range(first, first + self.mesh.local_shards)]).amax()
        return max_across_processes(gmax) if self.mesh.distributed else gmax

    def _encode(self, total: int, fn) -> dict:
        """``fn(lo, hi, device) -> {name: rows}`` over every row: one call
        on the device, or one per shard (ShardedRows)."""
        if self.mesh is None:
            return fn(0, total, self.device)
        return ShardedRows.build_many(self.mesh, total, fn)

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
        Rows are padded to a multiple of 4096 per shard, masked invalid."""
        self = cls.__new__(cls)
        self._configure(device, Metric.COSINE, Quantization.BQ, torch.bfloat16,
                        rerank_dtype if rr_codes is not None else None, False)
        if not torch.is_tensor(packed):
            packed = torch.from_numpy(np.array(packed).view(np.int32))
        if rr_codes is not None:
            rr_codes = torch.as_tensor(rr_codes)
        n, w = packed.shape
        self.n, self.dim = n, dim
        total = n + (-n) % (self._shards * 2 * _CHUNK)

        def encode(lo, hi, d):
            def rows(x, width):
                x = x[lo:min(hi, n)].to(d)
                return torch.cat([x, x.new_zeros((hi - lo - x.shape[0], width))])

            out = {"codes": rows(packed, w),
                   "valid": torch.arange(lo, hi, device=d) < n}
            if rr_codes is not None:
                out["rr_codes"] = rows(rr_codes, dim).to(rerank_dtype)
            return out

        self.scale = self.sqnorm = self.gscale = self.bin_live = self.rr_codes = None
        for name, value in self._encode(total, encode).items():
            setattr(self, name, value)
        return self

    def search_tensors(
        self, queries: torch.Tensor, k: int, *, oversample: int = 8,
        fused: bool = False, final: str = "auto", bypass_single: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` on a ``[Q, D]`` f32 tensor on the index's
        (first) device, returning device tensors ``(scores, ids)`` without
        waiting for the device (the bench queues batches through this).
        ``fused`` and ``final`` choose the scan of a non-unit_i8 index; a
        unit_i8 index always runs K2 with its own selection, as in the
        reference; a BQ index its Hamming shortlist (``fused`` and
        ``final`` unused). ``bypass_single=False`` runs the shard body on
        a one-device mesh (the dense scans only, as in the reference)."""
        where = self.placement
        if self.quantization == Quantization.BQ:
            return sharded_bq_topk(
                where, self.codes, self.valid, self.rr_codes, queries,
                k=k, oversample=oversample, dim=self.dim,
            )
        if self.unit_i8:
            return sharded_unit_i8_topk(
                where, self.codes, self.gscale, self.bin_live,
                self.valid, self.rr_codes, queries, k=k, oversample=oversample,
            )
        return sharded_scan_topk(
            where, self.codes, self.scale, self.sqnorm, self.valid,
            queries, k=k, metric=self.metric, compute_dtype=self.compute_dtype,
            rr_codes=self.rr_codes, oversample=oversample, fused=fused,
            final=final, bypass_single=bypass_single,
        )

    def search(
        self, queries, k: int, *, oversample: int = 8, fused: bool = False,
        final: str = "auto", bypass_single: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k of each query: host ``(scores [Q, k] 0-100, ids [Q, k])``;
        an empty slot has score -inf and id -1."""
        queries = torch.as_tensor(
            np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        scores, ids = self.search_tensors(queries, k, oversample=oversample,
                                          fused=fused, final=final,
                                          bypass_single=bypass_single)
        scores, ids = fetch_scores_ids(scores, ids)
        ids = np.where(np.isneginf(scores), -1, ids)
        return scores, ids


class DistributedPQIndex:
    """A PQ index on one device or row-sharded over a :class:`Mesh`:
    train once (sampled) unless a codebook is given, encode each shard's
    rows on its device, serve ADC scans with the codebook replicated. PQ
    codes at M = dim/8 are one byte per 8 floats."""

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
        self.mesh, self.device, self.placement = split(device)
        self.metric = Metric.parse(metric)
        self.compute_dtype = compute_dtype
        vectors = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
        self.n, self.dim = vectors.shape
        if codebook is None:
            codebook = train_pq(vectors, m=m, sample_size=train_sample,
                                opq_iters=opq_iters)
        self.codebook = codebook.to(self.device)
        if self.mesh is None:
            self.codes, self.sqnorm = pq_encode(vectors, self.codebook)
            self.valid = torch.ones(self.n, dtype=torch.bool, device=self.device)
            return
        n = self.n
        total = n + (-n) % self.mesh.shards
        books = {}

        def encode(lo, hi, d):
            x = vectors[lo:min(hi, n)].to(d)
            x = torch.cat([x, x.new_zeros((hi - lo - x.shape[0], self.dim))])
            book = books.setdefault(d, self.codebook.to(d))
            codes, sqnorm = pq_encode(x, book)
            return codes, sqnorm, torch.arange(lo, hi, device=d) < n

        self.codes, self.sqnorm, self.valid = ShardedRows.build_many(
            self.mesh, total, encode)

    def _replicas(self):
        """The codebook's arrays for the scans: replica dicts on a mesh."""
        cb = self.codebook
        if self.mesh is None:
            return cb.centroids, cb.rotation, cb.coarse
        if getattr(self, "_reps", None) is None:
            self._reps = tuple(replicate(self.mesh, t)
                               for t in (cb.centroids, cb.rotation, cb.coarse))
        return self._reps

    def search_tensors(self, queries: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`search` on a ``[Q, D]`` f32 tensor on the index's
        (first) device, returning device tensors ``(scores, ids)``."""
        centroids, rotation, coarse = self._replicas()
        return sharded_pq_topk(
            self.placement, self.codes, centroids, self.sqnorm,
            self.valid, queries, k=k, metric=self.metric,
            compute_dtype=self.compute_dtype, rotation=rotation, coarse=coarse,
        )

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k of each query: host ``(scores [Q, k] 0-100, ids [Q, k])``;
        an empty slot has score -inf and id -1."""
        queries = torch.as_tensor(
            np.atleast_2d(np.asarray(queries, np.float32))).to(self.device)
        scores, ids = fetch_scores_ids(*self.search_tensors(queries, k))
        return scores, np.where(np.isneginf(scores), -1, ids)
