"""Blocked scan + top-k on torch tensors (port of ``coltt_tpu/ops/topk.py``).

The reference's per-shard bounded heaps (``edge/f16_vectorstore.go:131-187``)
become a two-stage top-k: the row axis is cut into blocks that bound the
``[Q, block]`` score transients, each block yields its local top-k, and a
final ``torch.topk`` merges the ``[Q, blocks*k]`` partials.

The block budget comes from the device's free memory
(``torch.cuda.mem_get_info``), not from a constant sized for one card.
``rerank_neg_topk`` / ``rescore_topk`` re-score a shortlist against a
higher-precision copy of the rows.
"""

from __future__ import annotations

import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric, scan_distances
from coltt_tpu_torch.ops.score import normalize_score

# f32 [Q, block] tensors alive at once inside scan_distances + the
# selection (dots, the epilogue's temporaries, the masked distances)
_LIVE_SCORE_TENSORS = 4
# share of the free device memory one scan block may take
_FREE_SHARE = 4
# CPU tensors: fixed block budget (host memory is not queried)
_CPU_BUDGET = 1 << 30
_MIN_BLOCK = 8192


def _block_rows(n: int, q: int, row_bytes: int, device: torch.device) -> int:
    """Rows per scan block so that the block's transients fit the budget."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free // _FREE_SHARE
    else:
        budget = _CPU_BUDGET
    per_row = q * 4 * _LIVE_SCORE_TENSORS + row_bytes
    return max(_MIN_BLOCK, budget // per_row) if per_row * n > budget else n


# rows at most this wide are ranked by one stable sort; wider ones by
# torch.topk, then the tie group at the k-th rank settled
_SORT_WIDTH = 4096


def stable_topk(values: torch.Tensor, k: int, *, exact: bool = True):
    """Top-k of ``values [Q, N]`` (f32 or int32) along dim 1, largest
    first, equal values ranking the lower position first: ``lax.top_k``'s
    order, which ``torch.topk`` does not promise. Returns ``(values [Q,
    k], positions [Q, k] int64)``.

    Narrow rows take one stable sort. Wide ones take ``torch.topk`` of
    k + 1; a row whose (k+1)-th value equals its k-th has a tie group
    crossing the cut (rare for f32 distances) and keeps that group's
    lowest positions (:func:`_lowest_at_cut`), which costs one host sync.
    ``exact=False`` skips that step, as the reference's ``approx_max_k``
    may: the values at every rank are the same, the members of a group cut
    by k may not be."""
    n = values.shape[1]
    if n <= _SORT_WIDTH:
        v, pos = torch.sort(values, dim=1, descending=True, stable=True)
        return v[:, :k], pos[:, :k]
    if not exact or k == n:
        v, pos = torch.topk(values, k, dim=1, largest=True, sorted=True)
    else:
        v, pos = torch.topk(values, k + 1, dim=1, largest=True, sorted=True)
        cut = torch.nonzero(v[:, k] == v[:, k - 1]).flatten()
        v, pos = v[:, :k], pos[:, :k]
        if cut.numel():
            v[cut], pos[cut] = _lowest_at_cut(values[cut], v[cut], pos[cut], k)
    # equal values by the lower position: order by position, then stably
    # by value
    order = torch.argsort(pos, dim=1)
    v, pos = torch.gather(v, 1, order), torch.gather(pos, 1, order)
    order = torch.sort(v, dim=1, descending=True, stable=True).indices
    return torch.gather(v, 1, order), torch.gather(pos, 1, order)


def _lowest_at_cut(values, v, pos, k: int):
    """For rows whose tie group at the k-th value crosses the cut: keep
    ``torch.topk``'s members above that value, then fill with the group's
    lowest positions. Returns ``(v, pos) [R, k]``, unordered."""
    kth = v[:, -1:]
    above = v > kth          # every row above the k-th value is among these
    need = k - above.sum(dim=1, keepdim=True)
    n = values.shape[1]
    rev = torch.arange(n, 0, -1, dtype=torch.int32, device=values.device)
    tie = torch.topk(torch.where(values == kth, rev, 0), k, dim=1).values
    cand_pos = torch.cat([pos, (n - tie).to(pos.dtype)], dim=1)
    cand_v = torch.cat([v, kth.expand(-1, k)], dim=1)
    col = torch.arange(k, device=values.device)
    keep = torch.cat([above, col[None, :] < need], dim=1)   # k per row
    sel = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices[:, :k]
    return torch.gather(cand_v, 1, sel), torch.gather(cand_pos, 1, sel)


def scan_neg_topk(
    queries,
    codes,
    scale,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    block_rows=None,
):
    """Top-k scan returning raw ranking values ``(negdist [Q,k], ids [Q,k])``.

    Ranks on negated distance, not the 0-100 score (the euclidean score
    clips at 0 and would tie all far rows). ``block_rows=None`` sizes the
    blocks from the free memory of ``codes``' device. Equal distances rank
    the lower row id first, as in the reference (:func:`stable_topk`),
    except that a tie group crossing a block's k-th rank may keep other
    members than the reference's.
    """
    metric = Metric.parse(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=codes.device)
    n, d = codes.shape
    q = queries.shape[0]
    # the dequantized / compute-dtype copy of a code block
    row_bytes = 0 if codes.dtype == torch.float32 else d * 4 * 2
    block = block_rows or _block_rows(n, q, row_bytes, codes.device)
    kk = min(k, n)

    vals, ids = [], []
    for start in range(0, n, block):
        stop = min(n, start + block)
        dist = scan_distances(
            queries,
            codes[start:stop],
            None if scale is None else scale[start:stop],
            None if sqnorm is None else sqnorm[start:stop],
            None if valid is None else valid[start:stop],
            metric=metric,
            compute_dtype=compute_dtype,
        )
        # the block's own tie group at its cut is left unsettled: f32
        # distances of distinct rows rarely tie there, and settling it
        # costs a host sync a block (+10% on a plain SearchBatch)
        v, i = stable_topk(-dist, min(kk, stop - start), exact=False)
        vals.append(v)
        ids.append(i + start)
    if len(vals) == 1:
        return vals[0], ids[0].to(torch.int32)
    # block-major partials: equal values keep the lower block first
    negd, sel = stable_topk(torch.cat(vals, dim=1), kk)
    return negd, torch.gather(torch.cat(ids, dim=1), 1, sel).to(torch.int32)


def scan_topk(
    queries,
    codes,
    scale,
    sqnorm,
    valid,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    block_rows=None,
):
    """Top-k scan over the full store: ``(scores [Q, k], ids [Q, k])``,
    scores on the 0-100 scale, descending; tombstoned rows surface as -inf
    score (callers drop them)."""
    metric = Metric.parse(metric)
    negd, idx = scan_neg_topk(
        queries, codes, scale, sqnorm, valid,
        k=k, metric=metric, compute_dtype=compute_dtype, block_rows=block_rows,
    )
    return scores_from_negd(negd, metric), idx


def fit_rows(n: int, per_row_bytes: int, device: torch.device) -> int:
    """Rows (or queries) per block, at most ``n``, whose transients of
    ``per_row_bytes`` each fit a quarter of the free device memory (the
    fixed CPU budget on a CPU tensor). Work within the CPU budget goes in
    one block on any device, without asking the device."""
    if n * per_row_bytes <= _CPU_BUDGET:
        return max(1, n)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = free // _FREE_SHARE
    else:
        budget = _CPU_BUDGET
    return max(1, min(n, budget // max(1, per_row_bytes)))


def rerank_neg_topk(
    queries,
    negd,
    ids,
    rr_codes,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
    rr_scale=None,
):
    """Re-score shortlisted candidates against a higher-precision copy.

    ``negd / ids [Q, C]`` come from a (possibly approximate, low-bit)
    scan; ``rr_codes [N, D]`` is the rerank copy (e.g. bf16 rows), with an
    optional per-row ``rr_scale [N, 1]`` (an f8 copy's). A ``[Q, C, D]``
    gather feeds :func:`rescore_topk`, blocked over queries
    (:func:`fit_rows`; each query's rerank is independent, so the blocks
    change no result): at Q=2048, C=640, D=768 one bf16 gather alone is
    2 GB. Returns ``(negdist [Q, k], ids [Q, k])`` on the rerank
    precision.
    """
    metric = Metric.parse(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=rr_codes.device)
    q, c = ids.shape
    d = rr_codes.shape[1]
    # the gather, its f32 widening, its compute-dtype copy and the product
    per_query = c * d * (rr_codes.element_size() + 12)
    qb = fit_rows(q, per_query, rr_codes.device)
    outs = []
    for s in range(0, q, qb):
        safe = ids[s:s + qb].clamp(min=0).long()
        cand = rr_codes[safe]                               # [qb, C, D]
        if rr_scale is not None:
            cand = cand.to(torch.float32) * rr_scale[safe]
        outs.append(rescore_topk(queries[s:s + qb], cand, negd[s:s + qb],
                                 ids[s:s + qb], k=k, metric=metric,
                                 compute_dtype=compute_dtype))
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def rescore_topk(
    queries,
    cand,
    negd,
    ids,
    *,
    k: int,
    metric: Metric = Metric.COSINE,
    compute_dtype=torch.bfloat16,
):
    """Rank ``cand [Q, C, D]`` against ``queries [Q, D]`` and keep the top
    k of the shortlist; entries whose scan ``negd`` is not finite
    (tombstones, padding, empty slots) stay at infinite distance.

    Operands are rounded to ``compute_dtype`` and multiplied as f32, with
    f32 sums, as the reference's bf16 einsum with an f32 result: the
    product of two bf16 values is exact in f32. (A torch product of bf16
    tensors would round every dot to bf16.) Elementwise products and
    sums, not a matmul, so TF32 never applies.
    """
    metric = Metric.parse(metric)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=cand.device)
    qc = queries.to(compute_dtype).to(torch.float32)
    cc = cand.to(compute_dtype).to(torch.float32)
    dots = (cc * qc.unsqueeze(1)).sum(dim=2)                # [Q, C]
    csq = (cc * cc).sum(dim=2)
    if metric == Metric.COSINE:
        qn = torch.sqrt((queries * queries).sum(dim=1, keepdim=True))
        dist = 1.0 - dots / (qn * torch.sqrt(csq.clamp(min=0.0))).clamp(min=1e-30)
    else:
        qsq = (queries * queries).sum(dim=1, keepdim=True)
        dist = (qsq + csq - 2.0 * dots).clamp(min=0.0)
    dist = torch.where(torch.isfinite(negd), dist, float("inf"))
    kk = min(k, dist.shape[1])
    rneg, sel = stable_topk(-dist, kk)
    return rneg, torch.gather(ids, 1, sel)


def scores_from_negd(negd, metric: Metric):
    """Negated distances -> 0-100 scores, -inf kept for empty slots."""
    return torch.where(torch.isinf(negd), torch.full_like(negd, -float("inf")),
                       normalize_score(-negd, metric))


def fetch_scores_ids(scores, ids):
    """Device -> host: ``(scores [Q, k] f32, ids [Q, k] int32)`` numpy."""
    return scores.cpu().numpy(), ids.to(torch.int32).cpu().numpy()


def compute_recall(result_ids, truth_ids) -> float:
    """Fraction of ground-truth ids present in the results, averaged over
    queries (ComputeRecall parity, edge/resultset.go:54-64).

    Both arguments are ``[Q, k]`` id arrays; negative ids (empty slots)
    in the truth are ignored.
    """
    result_ids = np.asarray(result_ids)
    truth_ids = np.asarray(truth_ids)
    if result_ids.ndim == 1:
        result_ids = result_ids[None]
        truth_ids = truth_ids[None]
    total, hit = 0, 0
    for r in range(truth_ids.shape[0]):
        truth = set(int(t) for t in truth_ids[r] if t >= 0)
        if not truth:
            continue
        got = set(int(t) for t in result_ids[r])
        hit += len(truth & got)
        total += len(truth)
    return hit / total if total else 1.0
