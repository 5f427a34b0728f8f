"""HNSW graph index: host construction, batched device beam search.

Port of ``coltt_tpu/store/hnsw.py``. Reference parity: ``core/vectorindex/
hnsw.go`` (Insert with greedy upper descent + efConstruction beam per
level, simple|heuristic neighbor selection, bidirectional edges with
pruneNeighbors at mMax; Search greedy to level 0 then ef-bounded beam;
Remove marks deleted + relinks neighbors; RandomLevel from the exponential
distribution), ``hnsw_config.go`` (the full config surface) and
``hnsw_commit.go`` (Commit/Load binary snapshot, byte-compatible with the
JAX package's in both directions).

The host parts (``insert``, ``remove``, the host search, ``save`` /
``load``) are the reference's numpy code as it is: with the same seed and
the same inserts, levels, adjacency, entry and max level are bit-identical.
Random draws (levels, k-means samples, NN-descent rows) come from
``np.random.default_rng(seed)`` in both packages.

The device parts are torch ops on the index's ``device``. Search advances
all Q queries together: each step expands the closest unexpanded beam
entries per query, gathers their padded neighbor rows, drops ids already
in the beam or the expansion history (a per-row sort and ``searchsorted``,
O(Q x expand x m0) memory), scores the fresh frontier with one batched
product and merges by a stable top-k (equal distances keep the lower
position, as ``lax.top_k``). The reference's ``lax.while_loop`` conditions
live on the device; here the loops run their fixed count and test the
condition on the host only every ``LOOP_CHECK_EVERY`` hops (both bodies do
nothing once their condition is false, so the results are the same).

The cached device graph is mutable, unlike JAX arrays: a search snapshots
it under the index lock and runs without the lock, and while a snapshot is
live (``_readers > 0``) dirty rows are written out of place, so a
mutation never tears a running search (the store rule of
``store/flat.py`` ``sync``). Builders own their device tensors and update
them in place.
"""

from __future__ import annotations

import io
import math
import struct
import threading
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import msgpack
import numpy as np
import torch

from coltt_tpu_torch.ops.distance import Metric, _dot_scores
from coltt_tpu_torch.ops.topk import fetch_scores_ids, fit_rows, stable_topk
from coltt_tpu_torch.utils import trace

_SNAPSHOT_MAGIC = b"CTTHNSW1"

SIMPLE = "simple"
HEURISTIC = "heuristic"

# hops between host checks of a device loop's exit condition (0: run the
# fixed count with no host sync); read at every search
LOOP_CHECK_EVERY = 4

_INF = float("inf")

# a served search's work tally, one int64 device tensor read once with its
# results: hops, beam iterations, neighbour distances scored, adjacency
# rows expanded, query blocks
_WORK = ("descend_hops", "beam_iters", "scored", "expanded", "blocks")


@dataclass(frozen=True)
class HnswConfig:
    """Full reference config surface (hnsw_config.go:57-162)."""

    m: int = 16
    m_max: Optional[int] = None          # defaults to m
    m_max0: Optional[int] = None         # defaults to 2m
    ef: int = 20
    ef_construction: int = 200
    level_multiplier: Optional[float] = None  # defaults to 1/ln(m)
    algorithm: str = SIMPLE              # simple | heuristic
    heuristic_extend_candidates: bool = False
    heuristic_keep_pruned: bool = True

    def resolved(self) -> "HnswConfig":
        out = self
        if out.m_max is None:
            out = replace(out, m_max=out.m)
        if out.m_max0 is None:
            out = replace(out, m_max0=2 * out.m)
        if out.level_multiplier is None:
            out = replace(out, level_multiplier=1.0 / math.log(out.m))
        if out.algorithm not in (SIMPLE, HEURISTIC):
            raise ValueError(f"unknown algorithm {out.algorithm!r}")
        return out

    def to_dict(self) -> dict:
        c = self.resolved()
        return {
            "m": c.m, "m_max": c.m_max, "m_max0": c.m_max0, "ef": c.ef,
            "ef_construction": c.ef_construction,
            "level_multiplier": c.level_multiplier,
            "algorithm": c.algorithm,
            "heuristic_extend_candidates": c.heuristic_extend_candidates,
            "heuristic_keep_pruned": c.heuristic_keep_pruned,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HnswConfig":
        return cls(**d)


# ---------------------------------------------------------------------------
# device paths: distances, greedy descent, level-0 beam, edge updates
# ---------------------------------------------------------------------------

def _batched_dist(queries, vecs, sqn_q, sqn_v, metric: Metric,
                  compute_dtype=torch.float32):
    """queries [Q, D], vecs [Q, E, D] -> [Q, E] f32 distances.

    Operands are rounded to ``compute_dtype`` and summed in f32, as the
    reference's einsum with ``preferred_element_type=f32``: on the card a
    bf16 product runs ``torch.bmm(..., out_dtype=float32)``, on the CPU
    the bf16 operands are widened to f32 (products of bf16 values are
    exact in f32). No dot is ever rounded to bf16."""
    q = queries.to(compute_dtype)[:, :, None]
    v = vecs.to(compute_dtype)
    if compute_dtype == torch.float32:
        dots = torch.bmm(v, q)
    elif v.is_cuda:
        dots = torch.bmm(v, q, out_dtype=torch.float32)
    else:
        dots = torch.bmm(v.to(torch.float32), q.to(torch.float32))
    dots = dots[:, :, 0]
    if metric == Metric.COSINE:
        den = torch.sqrt(torch.clamp(sqn_q[:, None] * sqn_v, min=1e-30))
        return 1.0 - dots / den
    return torch.clamp(sqn_q[:, None] + sqn_v - 2.0 * dots, min=0.0)


def _check_now(it: int, check_every: int) -> bool:
    return check_every > 0 and it > 0 and it % check_every == 0


def _greedy_descent(vectors, sqnorms, adj, queries, cur, *, metric: Metric,
                    compute_dtype=torch.float32, max_hops: int = 64,
                    check_every: Optional[int] = None, work=None):
    """Batched greedy walk on one level (hnsw.go:320 greedyClosestNeighbor).

    adj [N, W] padded int32 for the level, queries [Q, D] f32, cur [Q]
    start vertices. Returns the per-query local minimum vertex ids [Q]
    (int64). Up to ``max_hops`` hops; every ``check_every`` hops the host
    stops the walk once every query is done (``done`` freezes ``cur``, so
    the extra hops of the fixed count change nothing). ``work`` (a
    ``_WORK`` tally) gains the walk's hops, scored neighbours and expanded
    rows."""
    check_every = LOOP_CHECK_EVERY if check_every is None else check_every
    qsq = (queries * queries).sum(dim=1)
    cur = cur.long()
    cur_d = _batched_dist(queries, vectors[cur][:, None, :], qsq,
                          sqnorms[cur][:, None], metric, compute_dtype)[:, 0]
    done = torch.zeros_like(cur, dtype=torch.bool)
    path = []
    for it in range(max_hops):
        if _check_now(it, check_every) and bool(done.all()):
            break
        if work is not None:
            path.append(cur)
        nbrs = adj[cur].long()                            # [Q, W]
        ok = nbrs >= 0
        safe = torch.where(ok, nbrs, 0)
        nd = _batched_dist(queries, vectors[safe], qsq, sqnorms[safe],
                           metric, compute_dtype)
        nd = torch.where(ok, nd, _INF)
        best = torch.argmin(nd, dim=1, keepdim=True)      # first minimum
        bd = nd.gather(1, best)[:, 0]
        improved = (bd < cur_d) & ~done
        cur = torch.where(improved, nbrs.gather(1, best)[:, 0], cur)
        cur_d = torch.where(improved, bd, cur_d)
        done = done | ~improved
    if path:
        _tally_walk(work, adj, path)
    return cur


def _tally_walk(work, adj, path):
    """Add a greedy walk's work to ``work``, from ``path`` (each query's
    vertex at the start of each hop run) alone, so the walk's loop pays
    nothing for it: a query walks in hop 0 and in each hop after one that
    moved it (a move is to a strictly nearer vertex, so never in place)."""
    p = torch.stack(path)                                 # [H, Q]
    walked = torch.ones_like(p, dtype=torch.bool)
    walked[1:] = p[1:] != p[:-1]
    work[0] += walked.any(dim=1).sum()
    work[2] += ((adj[p] >= 0) & walked[:, :, None]).sum()
    work[3] += walked.sum()


def _row_isin(values, table):
    """Per-row membership: ``values [Q, A]`` in ``table [Q, B]`` (int64)."""
    st = torch.sort(table, dim=1).values
    pos = torch.searchsorted(st, values).clamp(max=st.shape[1] - 1)
    return st.gather(1, pos) == values


def _first_in_row(ids, keep):
    """True at each ``keep`` position whose id has no earlier ``keep``
    position with the same id in its row (the reference's ``first_hit``
    without its [Q, A, A] compare): a stable sort by id, where entries
    not kept get unique negative keys, marks each equal run's first,
    which is its lowest position."""
    a = ids.shape[1]
    uniq = -1 - torch.arange(a, device=ids.device).expand_as(ids)
    key = torch.where(keep, ids, uniq)
    sk, order = torch.sort(key, dim=1, stable=True)
    first = torch.ones_like(keep)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    return torch.zeros_like(keep).scatter_(1, order, first) & keep


def _beam_search_l0(vectors, sqnorms, adj0, alive, queries, entry_ids, *,
                    ef: int, k: int, expand: int, max_iters: int,
                    metric: Metric, compute_dtype=torch.float32,
                    check_every: Optional[int] = None, work=None):
    """Batched ef-bounded best-first search on one level's graph.

    vectors [N, D], sqnorms [N] f32, adj0 [N, M0] int32 (-1 pad), alive [N]
    bool (False = tombstoned), queries [Q, D] f32, entry_ids [Q]. Returns
    (dists [Q, min(k, ef)] f32, ids [Q, min(k, ef)] int64) over alive
    vertices (pad id -1 / inf).

    Queries run in blocks sized from free device memory (each query's
    search is independent, so the blocks change no result). ``work`` (a
    ``_WORK`` tally) gains each block's iterations, scored neighbours and
    expanded rows, and the number of blocks."""
    check_every = LOOP_CHECK_EVERY if check_every is None else check_every
    expand = min(expand, ef)
    em = expand * adj0.shape[1]
    # the neighbour gather, its f32 copy, and the [Q, em] id / key work
    per_query = em * (vectors.shape[1] * (vectors.element_size() + 8) + 96)
    qb = fit_rows(queries.shape[0], per_query, queries.device)
    outs = [_beam_block(vectors, sqnorms, adj0, alive, queries[s:s + qb],
                        entry_ids[s:s + qb], ef=ef, k=k, expand=expand,
                        max_iters=max_iters, metric=metric,
                        compute_dtype=compute_dtype, check_every=check_every,
                        work=work)
            for s in range(0, queries.shape[0], qb)]
    if work is not None:
        work[4] += len(outs)
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _beam_block(vectors, sqnorms, adj0, alive, queries, entry_ids, *, ef, k,
                expand, max_iters, metric, compute_dtype, check_every,
                work=None):
    """One query block of :func:`_beam_search_l0`.

    Dedup is by comparison, not a visited bitmap: a candidate is fresh iff
    it is not in the current beam and not in the expansion history
    ([Q, expand * max_iters] ids). An expanded node can never re-enter; an
    evicted-unexpanded node may be re-scored once, as in the reference.
    The loop stops early only when no query has an unexpanded finite beam
    entry: then a step changes nothing (the merge keeps the beam, its own
    entries winning ties against the fresh infinite ones). The tally reads
    the expansion history at the end: an iteration counts where some query
    expanded an entry, which is the reference's loop condition."""
    dev = queries.device
    q = queries.shape[0]
    m0 = adj0.shape[1]
    em = expand * m0
    qsq = (queries * queries).sum(dim=1)
    entry_ids = entry_ids.long()

    beam_ids = torch.full((q, ef), -1, dtype=torch.long, device=dev)
    beam_dist = torch.full((q, ef), _INF, dtype=torch.float32, device=dev)
    beam_exp = torch.zeros((q, ef), dtype=torch.bool, device=dev)
    beam_ids[:, 0] = entry_ids
    beam_dist[:, 0] = _batched_dist(
        queries, vectors[entry_ids][:, None, :], qsq,
        sqnorms[entry_ids][:, None], metric, compute_dtype)[:, 0]
    hist = torch.full((q, expand * max_iters), -1, dtype=torch.long, device=dev)
    if work is not None:
        fresh_n = torch.zeros(max_iters, dtype=torch.long, device=dev)

    for it in range(max_iters):
        frontier = torch.where(beam_exp, _INF, beam_dist)
        if _check_now(it, check_every) and not bool(torch.isfinite(frontier).any()):
            break
        _, pick = stable_topk(-frontier, expand)                # [Q, E]
        pick_ids = beam_ids.gather(1, pick)
        pick_live = torch.isfinite(frontier.gather(1, pick))
        beam_exp = beam_exp.scatter(1, pick, beam_exp.gather(1, pick) | pick_live)
        hist[:, it * expand:(it + 1) * expand] = torch.where(pick_live, pick_ids, -1)

        safe_pick = torch.where(pick_live & (pick_ids >= 0), pick_ids, 0)
        nbrs = adj0[safe_pick].reshape(q, em).long()
        nbr_ok = (nbrs >= 0) & pick_live.repeat_interleave(m0, dim=1)
        safe_nbrs = torch.where(nbr_ok, nbrs, 0)

        # fresh = not in beam, not already expanded, first in-row occurrence
        fresh = (nbr_ok & ~_row_isin(safe_nbrs, beam_ids)
                 & ~_row_isin(safe_nbrs, hist))
        fresh = _first_in_row(safe_nbrs, fresh)
        if work is not None:
            torch.sum(fresh, dim=(0, 1), out=fresh_n[it])

        ndist = _batched_dist(queries, vectors[safe_nbrs], qsq,
                              sqnorms[safe_nbrs], metric, compute_dtype)
        ndist = torch.where(fresh, ndist, _INF)

        all_ids = torch.cat([beam_ids, nbrs], dim=1)
        all_dist = torch.cat([beam_dist, ndist], dim=1)
        all_exp = torch.cat([beam_exp, ~fresh], dim=1)  # fresh: unexpanded
        negd, sel = stable_topk(-all_dist, ef)
        beam_ids = all_ids.gather(1, sel)
        beam_dist = -negd
        beam_exp = all_exp.gather(1, sel)

    if work is not None:
        live = (hist >= 0).view(q, max_iters, expand)
        work[1] += live.any(dim=2).any(dim=0).sum()
        work[2] += fresh_n.sum()
        work[3] += live.sum()

    # filter tombstoned vertices from results
    safe = torch.where(beam_ids >= 0, beam_ids, 0)
    ok = (beam_ids >= 0) & alive[safe]
    final = torch.where(ok, beam_dist, _INF)
    negd, sel = stable_topk(-final, min(k, ef))
    dists = -negd
    ids = torch.where(torch.isinf(dists), -1, beam_ids.gather(1, sel))
    return dists, ids


def _rebuild_rows(vectors, sqnorms, adj, row_ids, extra, *, metric: Metric,
                  compute_dtype=torch.float32) -> None:
    """Reverse-edge insertion with pruning, vectorized over rows, in place.

    For each row r in ``row_ids [U]`` (distinct): merge its current
    neighbors ``adj[r] [W]`` with the new candidate ids ``extra[r] [P]``
    (-1 pad) and keep the W closest to vertex r — the simple-selection form
    of pruneNeighbors (hnsw.go:449)."""
    existing = adj[row_ids].long()                        # [U, W]
    w = existing.shape[1]
    extra = extra.long()
    # drop extras already present in the row (refinement re-merges)
    dup = (extra[:, :, None] == existing[:, None, :]).any(dim=2)
    extra = torch.where(dup, -1, extra)
    allids = torch.cat([existing, extra], dim=1)          # [U, W+P]
    ok = allids >= 0
    safe = torch.where(ok, allids, 0)
    d = _batched_dist(vectors[row_ids].to(torch.float32), vectors[safe],
                      sqnorms[row_ids], sqnorms[safe], metric, compute_dtype)
    d = torch.where(ok, d, _INF)
    negd, sel = stable_topk(-d, w)
    new_rows = torch.where(torch.isfinite(negd), allids.gather(1, sel), -1)
    adj[row_ids] = new_rows.to(adj.dtype)


def _heuristic_select(vectors, sqnorms, cand_d, cand_ids, *, m: int,
                      metric: Metric, keep_pruned: bool,
                      compute_dtype=torch.float32):
    """Vectorized selectNeighborsHeuristic (hnsw.go:399) over B rows.

    cand_d / cand_ids are [B, C] candidate distances / ids sorted ascending
    (-1 / inf padding). m greedy rounds: each round admits the closest
    still-admissible candidate, then drops candidates that are closer to it
    than to the query. keep_pruned backfills remaining slots with the
    pruned candidates in distance order. Returns [B, m] int64 ids."""
    b, c = cand_ids.shape
    dev = cand_ids.device
    cand_ids = cand_ids.long()
    iota = torch.arange(b, device=dev)
    valid = cand_ids >= 0
    safe = torch.where(valid, cand_ids, 0)
    cvec = vectors[safe]                                  # [B, C, D]
    csq = sqnorms[safe]                                   # [B, C]
    sel = torch.full((b, m), -1, dtype=torch.long, device=dev)
    chosen = torch.zeros((b, c), dtype=torch.bool, device=dev)
    admissible = valid
    for r in range(m):
        has = admissible.any(dim=1)
        pick = admissible.to(torch.uint8).argmax(dim=1)   # first True
        sel[:, r] = torch.where(has, cand_ids[iota, pick], -1)
        chosen[iota, pick] |= has
        pv = cvec[iota, pick].to(torch.float32)           # [B, D]
        dd = _batched_dist(pv, cvec, csq[iota, pick], csq, metric, compute_dtype)
        admissible = torch.where(has[:, None], admissible & (cand_d < dd),
                                 admissible) & ~chosen
    if keep_pruned:
        cnt = (sel >= 0).sum(dim=1)
        rem = valid & ~chosen
        slotpos = cnt[:, None] + torch.cumsum(rem, dim=1) - 1
        write = rem & (slotpos < m)
        out = torch.cat([sel, sel.new_full((b, 1), -1)], dim=1)
        # every dropped write lands in the spare last column, all as -1
        out.scatter_(1, torch.where(write, slotpos, m),
                     torch.where(write, cand_ids, -1))
        sel = out[:, :m]
    return sel


def _drop_self(cand_d, cand_ids, own):
    """Remove each row's own id from its candidate list (refinement pass)."""
    bad = cand_ids == own[:, None]
    negd, sel = stable_topk(-torch.where(bad, _INF, cand_d), cand_d.shape[1])
    ids = cand_ids.gather(1, sel)
    return -negd, torch.where(torch.isinf(negd), -1, ids)


# ---------------------------------------------------------------------------
# clustered-build device paths (bulk_build_clustered)
# ---------------------------------------------------------------------------

def _pow2_ceil(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _lloyd_step(xs, cents, *, cosine: bool):
    """One Lloyd iteration: assignment is a product argmax, the update a
    one-hot product (no scatter-add, so no atomics: the same inputs give
    the same centroids bit for bit). ``xs`` is f32 (unit-norm for cosine);
    empty clusters keep their previous centroid."""
    if cosine:
        sims = xs @ cents.T
    else:
        sims = 2.0 * (xs @ cents.T) - (cents * cents).sum(dim=1)[None, :]
    best = torch.argmax(sims, dim=1)
    onehot = (best[:, None] == torch.arange(cents.shape[0], device=xs.device)[None, :]
              ).to(torch.float32)
    sums = onehot.T @ xs
    cnt = onehot.sum(dim=0)
    new = torch.where(cnt[:, None] > 0, sums / torch.clamp(cnt, min=1.0)[:, None],
                      cents)
    if cosine:
        new = new / torch.clamp(torch.linalg.norm(new, dim=1, keepdim=True), min=1e-30)
    return new


def _assign_spill(x, cents, *, spill: int, cosine: bool):
    """Top-``spill`` nearest clusters per row. For cosine the row norm
    scales every cluster score equally, so the raw dot ranking suffices."""
    xf = x.to(torch.float32)
    if cosine:
        sims = xf @ cents.T
    else:
        sims = 2.0 * (xf @ cents.T) - (cents * cents).sum(dim=1)[None, :]
    return stable_topk(sims, spill)[1]


def _select_forward(d_vecs, d_sqn, cand_d, cand_ids, *, m, metric, heuristic,
                    keep_pruned, compute_dtype):
    if heuristic:
        return _heuristic_select(d_vecs, d_sqn, cand_d, cand_ids, m=m,
                                 metric=metric, keep_pruned=keep_pruned,
                                 compute_dtype=compute_dtype)
    return cand_ids[:, :m]


def _cluster_connect(d_vecs, d_sqn, q_gids, col_gids, col_valid, *, efc: int,
                     m: int, metric: Metric, heuristic: bool,
                     keep_pruned: bool, compute_dtype):
    """Forward-edge selection for one cluster block: ONE [rows, cols]
    product scores every member against the cluster's columns (members +
    spill-ins), the exact top-efConstruction forms the candidate list
    (the reference's ``approx_max_k`` is exact on the CPU it is held on),
    and the (optionally heuristic) selection picks the m forward neighbors.
    Returns [rows, m] global ids (-1 pad)."""
    qs = d_sqn[q_gids]
    cs = d_sqn[col_gids]
    dots = _dot_scores(d_vecs[q_gids].to(torch.float32), d_vecs[col_gids], None,
                       compute_dtype)
    if metric == Metric.COSINE:
        dist = 1.0 - dots / torch.sqrt(torch.clamp(qs[:, None] * cs[None, :], min=1e-30))
    else:
        dist = torch.clamp(qs[:, None] + cs[None, :] - 2.0 * dots, min=0.0)
    mask = col_valid[None, :] & (col_gids[None, :] != q_gids[:, None])
    dist = torch.where(mask, dist, _INF)
    neg, sel = stable_topk(-dist, min(efc, dist.shape[1]))
    cand_ids = torch.where(torch.isfinite(neg), col_gids[sel], -1)
    return _select_forward(d_vecs, d_sqn, -neg, cand_ids, m=m, metric=metric,
                           heuristic=heuristic, keep_pruned=keep_pruned,
                           compute_dtype=compute_dtype)


def _nn_descent_block(d_vecs, d_sqn, adj, rows, rand, *, efc: int, m: int,
                      metric: Metric, heuristic: bool, keep_pruned: bool,
                      compute_dtype):
    """One NN-descent candidate pass for ``rows [B]``: candidates are the
    row's current neighbors PLUS its neighbors' neighbors PLUS ``rand``
    uniformly sampled rows, then top-efConstruction + (heuristic) selection
    picks the new m forward edges. The random candidates supply the
    long-range edges a cluster-partitioned init misses. Returns [B, m]
    global ids (-1 pad)."""
    b = rows.shape[0]
    nb = adj[rows].long()                                 # [B, W]
    w = nb.shape[1]
    safe_nb = torch.where(nb >= 0, nb, rows[:, None])
    nn = adj[safe_nb.reshape(-1)].long().reshape(b, w * w)
    cand = torch.cat([safe_nb, nn, rand.long()], dim=1)   # [B, W+W*W+R]
    cand = torch.where(cand == rows[:, None], -1, cand)   # drop self
    # dedup by sort + adjacent equality
    cand = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    ok = (cand >= 0) & ~dup
    safe = torch.where(ok, cand, 0)
    d = _batched_dist(d_vecs[rows].to(torch.float32), d_vecs[safe], d_sqn[rows],
                      d_sqn[safe], metric, compute_dtype)
    d = torch.where(ok, d, _INF)
    neg, sel = stable_topk(-d, min(efc, d.shape[1]))
    cand_ids = torch.where(torch.isfinite(neg), cand.gather(1, sel), -1)
    return _select_forward(d_vecs, d_sqn, -neg, cand_ids, m=m, metric=metric,
                           heuristic=heuristic, keep_pruned=keep_pruned,
                           compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# host index
# ---------------------------------------------------------------------------

def _locked(fn):
    """Serialize a mutating HnswIndex method under the index lock (RLock:
    bulk builds re-enter through insert)."""
    def wrapper(self, *a, **kw):
        with self._mu:
            return fn(self, *a, **kw)
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def _pow2_batch(limit: int) -> int:
    b = 1
    while b * 2 <= limit:
        b *= 2
    return b


class HnswIndex:
    """HNSW over dense int slots (the engine maps external ids <-> slots).

    ``device_dtype`` is the storage / compute dtype of the device graph
    that batched search reads (bf16 halves the gathered bytes;
    accumulation stays f32); host construction always computes in f32.
    Every device tensor lives on ``device``."""

    def __init__(
        self,
        dim: int,
        *,
        metric: Metric = Metric.COSINE,
        config: Optional[HnswConfig] = None,
        seed: int = 0,
        base_capacity: int = 1024,
        device_dtype=torch.float32,
        device="cuda",
    ):
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        if self.metric == Metric.MANHATTAN:
            raise ValueError("HNSW supports cosine/euclidean")
        self.config = (config or HnswConfig()).resolved()
        self.device_dtype = device_dtype
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)

        cap = max(base_capacity, 1024)
        self._vecs = np.zeros((cap, self.dim), np.float32)
        self._sqn = np.zeros(cap, np.float32)
        self._levels = np.full(cap, -1, np.int32)   # -1 = unallocated
        self._alive = np.zeros(cap, bool)
        # adjacency: level -> [cap_l, width] padded int32 (-1)
        self._adj: List[np.ndarray] = [
            np.full((cap, self.config.m_max0), -1, np.int32)
        ]
        self._count = 0
        self._next = 0
        self._entry = -1          # entrypoint slot
        self._max_level = 0
        self._device_cache = None  # capacity-shaped; see _device_graph
        self._dirty: set = set()   # host rows newer than the device cache
        # live lock-free search snapshots of the device cache (see search):
        # counted up under _mu with the snapshot, down under _readers_mu
        # alone, so a finished search does not queue behind a mutation
        # for the index lock (a stale count only makes a write go out of
        # place)
        self._readers = 0
        self._readers_mu = threading.Lock()
        # one lock makes concurrent insert/remove vs search safe (the
        # reference carries per-vertex locks here, hnsw.go:50-51):
        # mutations and the host-side parts of search serialize; the
        # batched device search runs on a snapshot without the lock.
        self._mu = threading.RLock()

    # -- internals ----------------------------------------------------------
    def _invalidate_cache(self) -> None:
        self._device_cache = None
        self._dirty.clear()

    def _ensure_capacity(self, n: int) -> None:
        cap = self._vecs.shape[0]
        if n <= cap:
            return
        self._invalidate_cache()  # capacity-shaped cache no longer fits
        new = cap
        while new < n:
            new *= 2
        grow = new - cap
        self._vecs = np.concatenate([self._vecs, np.zeros((grow, self.dim), np.float32)])
        self._sqn = np.concatenate([self._sqn, np.zeros(grow, np.float32)])
        self._levels = np.concatenate([self._levels, np.full(grow, -1, np.int32)])
        self._alive = np.concatenate([self._alive, np.zeros(grow, bool)])
        for lvl in range(len(self._adj)):
            w = self._adj[lvl].shape[1]
            self._adj[lvl] = np.concatenate(
                [self._adj[lvl], np.full((grow, w), -1, np.int32)]
            )

    def _ensure_level(self, level: int) -> None:
        if len(self._adj) <= level:
            self._invalidate_cache()  # cache carries one array per level
        while len(self._adj) <= level:
            self._adj.append(
                np.full((self._vecs.shape[0], self.config.m_max), -1, np.int32)
            )

    def _dist_many(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        v = self._vecs[ids]
        dots = v @ q
        if self.metric == Metric.COSINE:
            qn = math.sqrt(float(q @ q)) or 1e-30
            vn = np.sqrt(np.maximum(self._sqn[ids], 1e-30))
            return 1.0 - dots / (qn * vn)
        return np.maximum(float(q @ q) + self._sqn[ids] - 2.0 * dots, 0.0)

    def random_level(self) -> int:
        # RandomLevel parity (hnsw.go:280-282): floor(-ln(U) * mL)
        u = self._rng.random()
        return int(-math.log(max(u, 1e-12)) * self.config.level_multiplier)

    # -- greedy upper descent (hnsw.go:320 greedyClosestNeighbor) -----------
    def _greedy_level(self, q: np.ndarray, start: int, level: int) -> int:
        cur = start
        cur_d = float(self._dist_many(q, np.array([cur]))[0])
        while True:
            nbrs = self._adj[level][cur]
            nbrs = nbrs[nbrs >= 0]
            if nbrs.size == 0:
                return cur
            ds = self._dist_many(q, nbrs)
            j = int(np.argmin(ds))
            if ds[j] < cur_d:
                cur, cur_d = int(nbrs[j]), float(ds[j])
            else:
                return cur

    # -- beam search on one level (hnsw.go:345 searchLevel), host numpy -----
    def _search_level(self, q: np.ndarray, entry: int, ef: int, level: int
                      ) -> List[Tuple[float, int]]:
        import heapq

        d0 = float(self._dist_many(q, np.array([entry]))[0])
        visited = {entry}
        cand = [(d0, entry)]                  # min-heap of frontier
        best: List[Tuple[float, int]] = [(-d0, entry)]  # max-heap (neg) of results
        while cand:
            d, node = heapq.heappop(cand)
            if d > -best[0][0] and len(best) >= ef:
                break
            nbrs = self._adj[level][node]
            nbrs = [int(x) for x in nbrs[nbrs >= 0] if int(x) not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            ds = self._dist_many(q, np.array(nbrs))
            for nd, nn in zip(ds, nbrs):
                nd = float(nd)
                if len(best) < ef or nd < -best[0][0]:
                    heapq.heappush(cand, (nd, nn))
                    heapq.heappush(best, (-nd, nn))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted([(-d, n) for d, n in best])

    # -- neighbor selection (hnsw.go:399 selectNeighborsHeuristic) ----------
    def _select_neighbors(
        self, q: np.ndarray, candidates: List[Tuple[float, int]], m: int, level: int
    ) -> List[int]:
        if self.config.algorithm == SIMPLE or len(candidates) <= m:
            return [n for _, n in sorted(candidates)[:m]]
        cand = sorted(candidates)
        if self.config.heuristic_extend_candidates:
            seen = {n for _, n in cand}
            extra = []
            for _, n in list(cand):
                for nb in self._adj[level][n]:
                    nb = int(nb)
                    if nb >= 0 and nb not in seen:
                        seen.add(nb)
                        extra.append(nb)
            if extra:
                ds = self._dist_many(q, np.array(extra))
                cand = sorted(cand + list(zip(map(float, ds), extra)))
        selected: List[Tuple[float, int]] = []
        pruned: List[Tuple[float, int]] = []
        for d, n in cand:
            if len(selected) >= m:
                break
            # keep n only if it is closer to q than to any already-selected
            ok = True
            if selected:
                sel_ids = np.array([s for _, s in selected])
                dn = self._dist_many(self._vecs[n], sel_ids)
                ok = bool(np.all(d < dn))
            if ok:
                selected.append((d, n))
            else:
                pruned.append((d, n))
        if self.config.heuristic_keep_pruned:
            for d, n in pruned:
                if len(selected) >= m:
                    break
                selected.append((d, n))
        return [n for _, n in selected]

    def _add_edge(self, a: int, b: int, level: int) -> None:
        self._dirty.add(int(a))
        row = self._adj[level][a]
        if b in row:
            return
        slot = np.where(row < 0)[0]
        m_max = self.config.m_max0 if level == 0 else self.config.m_max
        if slot.size:
            row[slot[0]] = b
        else:
            # prune (hnsw.go:449 pruneNeighbors): keep best m_max among
            # existing + new by the configured selection algorithm
            ids = np.append(row[row >= 0], b)
            ds = self._dist_many(self._vecs[a], ids)
            keep = self._select_neighbors(
                self._vecs[a], list(zip(map(float, ds), map(int, ids))), m_max, level
            )
            new_row = np.full(row.shape, -1, np.int32)
            new_row[: len(keep)] = keep
            self._adj[level][a] = new_row

    # -- public API ----------------------------------------------------------
    def __len__(self) -> int:
        return self._count

    @property
    def entrypoint(self) -> int:
        return self._entry

    def insert(self, vector: np.ndarray, *, slot: Optional[int] = None,
               level: Optional[int] = None) -> int:
        """Insert (hnsw.go:104-167). Returns the slot."""
        with self._mu:
            return self._insert_locked(vector, slot=slot, level=level)

    def _insert_locked(self, vector, *, slot, level) -> int:
        q = np.asarray(vector, np.float32).reshape(-1)
        if q.shape[0] != self.dim:
            raise ValueError(f"dim {q.shape[0]} != index dim {self.dim}")
        if slot is None:
            slot = self._next
        self._next = max(self._next, slot + 1)
        self._ensure_capacity(self._next)
        if self._alive[slot] or self._levels[slot] >= 0:
            raise ValueError(f"slot {slot} already occupied")

        lvl = self.random_level() if level is None else int(level)
        self._ensure_level(lvl)
        self._vecs[slot] = q
        self._sqn[slot] = float(q @ q)
        self._levels[slot] = lvl
        self._alive[slot] = True
        self._count += 1
        self._dirty.add(int(slot))

        if self._entry < 0:
            self._entry = slot
            self._max_level = lvl
            return slot

        cur = self._entry
        # greedy descend from top level to lvl+1
        for l in range(self._max_level, lvl, -1):
            cur = self._greedy_level(q, cur, l)
        # beam + connect from min(max_level, lvl) down to 0
        for l in range(min(self._max_level, lvl), -1, -1):
            cand = self._search_level(q, cur, self.config.ef_construction, l)
            m = self.config.m
            nbrs = self._select_neighbors(q, cand, m, l)
            for nb in nbrs:
                self._add_edge(slot, nb, l)
                self._add_edge(nb, slot, l)
            if cand:
                cur = cand[0][1]
        if lvl > self._max_level:
            self._max_level = lvl
            self._entry = slot
        return slot

    # -- bulk construction ----------------------------------------------------
    def _upload(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        """A device copy of a host array (never a view of it, also on the
        CPU: host mutations must not reach a device snapshot)."""
        t = torch.tensor(arr, device=self.device)
        return t if dtype is None else t.to(dtype)

    def _connect_batch(self, d_vecs, d_sqn, adj, level: int,
                       new_slots: np.ndarray, cand_d, cand_ids,
                       overwrite_forward: bool = True) -> None:
        """Connect a batch of new vertices at one level (device adjacency,
        updated in place).

        Forward edges: neighbor selection (simple top-m or the vectorized
        heuristic) over the beam candidates. Reverse edges: group by target
        row on host (ids only), then `_rebuild_rows` merges + prunes each
        affected row on device."""
        cfg = self.config
        width = cfg.m_max0 if level == 0 else cfg.m_max
        m = min(cfg.m, width)
        cdt = d_vecs.dtype
        fwd_ids = _select_forward(
            d_vecs, d_sqn, cand_d, cand_ids, m=m, metric=self.metric,
            heuristic=cfg.algorithm == HEURISTIC,
            keep_pruned=cfg.heuristic_keep_pruned, compute_dtype=cdt)
        j_slots = torch.as_tensor(new_slots, dtype=torch.long, device=self.device)
        if overwrite_forward:
            fwd_rows = torch.full((len(new_slots), width), -1, dtype=adj.dtype,
                                  device=self.device)
            fwd_rows[:, :m] = fwd_ids.to(adj.dtype)
            adj[j_slots] = fwd_rows
        else:
            # refinement: merge fresh candidates into the existing row,
            # keeping the closest `width` (duplicates collapse via prune)
            _rebuild_rows(d_vecs, d_sqn, adj, j_slots, fwd_ids,
                          metric=self.metric, compute_dtype=cdt)
        f = fwd_ids.cpu().numpy()
        self._reverse_connect(d_vecs, d_sqn, adj, f.ravel(),
                              np.repeat(new_slots, f.shape[1]), compute_dtype=cdt)

    def _reverse_connect(self, d_vecs, d_sqn, adj, nbr, newp, *,
                         compute_dtype, chunk_rows: Optional[int] = None) -> None:
        """Insert reverse edges ``newp[i] -> row nbr[i]`` with pruning, in
        place.

        Pairs are deduped and grouped by target row on host (ids only),
        then `_rebuild_rows` merges + prunes each affected row on device,
        at most ``p`` extras a row per pass. The rows of one pass are
        distinct, so how they are chunked changes no edge: chunks are sized
        from free device memory (``chunk_rows`` forces them)."""
        keep = nbr >= 0
        nbr, newp = nbr[keep], newp[keep]
        if nbr.size == 0:
            return
        pair_key = nbr.astype(np.int64) * np.int64(d_vecs.shape[0]) + newp
        _, first = np.unique(pair_key, return_index=True)
        nbr, newp = nbr[first], newp[first]
        order = np.argsort(nbr, kind="stable")
        nbr, newp = nbr[order], newp[order]
        uniq, starts, counts = np.unique(nbr, return_index=True,
                                         return_counts=True)
        p = 1
        while p < min(int(counts.max()), 32):
            p *= 2
        width = int(adj.shape[1])
        # the [U, W+P, D] candidate gather and its f32 copy per row
        per_row = (width + p) * d_vecs.shape[1] * (d_vecs.element_size() + 4)
        offset = 0
        while True:
            active = counts > offset
            if not active.any():
                break
            rows_r = uniq[active]
            cnt_r = np.minimum(counts[active] - offset, p)
            idx = starts[active][:, None] + offset + np.arange(p)[None, :]
            ok = np.arange(p)[None, :] < cnt_r[:, None]
            extras = np.where(ok, newp[np.minimum(idx, newp.size - 1)], -1)
            chunk = chunk_rows or fit_rows(len(rows_r), per_row, self.device)
            for st in range(0, len(rows_r), chunk):
                _rebuild_rows(
                    d_vecs, d_sqn, adj,
                    torch.as_tensor(rows_r[st:st + chunk], dtype=torch.long,
                                    device=self.device),
                    torch.as_tensor(extras[st:st + chunk], dtype=torch.long,
                                    device=self.device),
                    metric=self.metric, compute_dtype=compute_dtype,
                )
            offset += p

    def _descend(self, d_vecs, d_sqn, d_adj, bq, top: int, build_dtype):
        """Batched greedy descent from the entry point through levels
        ``top .. 1`` of the device adjacency ``d_adj``."""
        cur = torch.full((bq.shape[0],), self._entry, dtype=torch.long,
                         device=self.device)
        for l in range(top, 0, -1):
            cur = _greedy_descent(d_vecs, d_sqn, d_adj[l], bq, cur,
                                  metric=self.metric, compute_dtype=build_dtype)
        return cur

    @_locked
    def bulk_build(
        self,
        vectors: np.ndarray,
        *,
        seed_size: int = 1024,
        batch_rows: int = 2048,
        expand: int = 16,
        refine_rounds: int = 1,
        build_dtype=torch.bfloat16,
        levels: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Device-accelerated batch construction on an empty index.

        A small sequential host seed establishes the upper-level skeleton;
        then power-of-two batches run their efConstruction candidate beams
        on the device (`_beam_search_l0` over every level's padded
        adjacency), with forward selection (simple top-m or the vectorized
        heuristic — extendCandidates is host-path-only) and reverse-edge
        insertion + pruning. Points within a batch do not see each other as
        candidates (the parallel-HNSW relaxation). ``refine_rounds`` extra
        passes re-search the finished graph for every point and merge the
        fresh candidates into both edge directions.

        Returns the assigned slots (0..N-1 in input order).
        """
        if self._count != 0 or self._next != 0:
            raise RuntimeError("bulk_build requires an empty index")
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        n, d = vecs.shape
        if d != self.dim:
            raise ValueError(f"dim {d} != index dim {self.dim}")
        if n == 0:
            return np.zeros(0, np.int32)
        cfg = self.config
        if levels is None:
            u = self._rng.random(n)
            levels = np.floor(
                -np.log(np.maximum(u, 1e-12)) * cfg.level_multiplier
            ).astype(np.int32)
        else:
            levels = np.asarray(levels, np.int32)

        self._ensure_capacity(n)
        self._ensure_level(int(levels.max(initial=0)))

        # 1) sequential host seed — defines the upper-level skeleton
        seed = max(1, min(seed_size, n))
        for i in range(seed):
            self.insert(vecs[i], slot=i, level=int(levels[i]))
        if seed == n:
            return np.arange(n, dtype=np.int32)

        # stage remaining rows into the host arrays (alive set per batch)
        self._vecs[seed:n] = vecs[seed:]
        self._sqn[seed:n] = np.einsum(
            "nd,nd->n", vecs[seed:], vecs[seed:], dtype=np.float32
        )
        self._levels[seed:n] = levels[seed:]
        self._next = n

        # device state over the full capacity; future rows prefilled
        # (unreachable until edges point at them). Distances accumulate in
        # f32 whatever the build dtype.
        d_vecs = self._upload(self._vecs, build_dtype)
        d_sqn = self._upload(self._sqn)
        d_alive = self._upload(self._alive)
        d_adj = [self._upload(a) for a in self._adj]
        efc = cfg.ef_construction
        max_iters = max(2 * efc // max(expand, 1), 16)
        beam = dict(ef=efc, k=efc, expand=expand, max_iters=max_iters,
                    metric=self.metric, compute_dtype=build_dtype)

        pos = seed
        while pos < n:
            b = _pow2_batch(min(batch_rows, pos, n - pos))
            slots = np.arange(pos, pos + b, dtype=np.int32)
            bl = levels[pos:pos + b]
            bq = self._upload(vecs[pos:pos + b])
            cur = torch.full((b,), self._entry, dtype=torch.long, device=self.device)

            for l in range(self._max_level, 0, -1):
                cur = _greedy_descent(
                    d_vecs, d_sqn, d_adj[l], bq, cur, metric=self.metric,
                    compute_dtype=build_dtype,
                )
                sub = np.where(bl >= l)[0]
                if sub.size == 0:
                    continue
                j_sub = torch.as_tensor(sub, dtype=torch.long, device=self.device)
                cand_dist, cand_ids = _beam_search_l0(
                    d_vecs, d_sqn, d_adj[l], d_alive, bq[j_sub], cur[j_sub], **beam)
                self._connect_batch(d_vecs, d_sqn, d_adj[l], l, slots[sub],
                                    cand_dist, cand_ids)
                cur[j_sub] = cand_ids[:, 0]

            cand_dist, cand_ids = _beam_search_l0(
                d_vecs, d_sqn, d_adj[0], d_alive, bq, cur, **beam)
            self._connect_batch(d_vecs, d_sqn, d_adj[0], 0, slots, cand_dist,
                                cand_ids)

            d_alive[pos:pos + b] = True
            self._alive[slots] = True
            self._count += b
            bmax = int(bl.max())
            if bmax > self._max_level:
                self._max_level = bmax
                self._entry = int(slots[int(np.argmax(bl))])
            pos += b

        # refinement: every point re-searches the finished graph; merges
        # (not overwrites) both edge directions
        for _ in range(max(0, refine_rounds)):
            self._refine_round(d_vecs, d_sqn, d_alive, d_adj, batch_rows, beam)

        for l in range(len(self._adj)):
            self._adj[l] = d_adj[l].cpu().numpy().copy()
        self._invalidate_cache()
        return np.arange(n, dtype=np.int32)

    def _refine_round(self, d_vecs, d_sqn, d_alive, d_adj, batch_rows, beam):
        """One beam-refinement round over rows 0..next-1 (level 0)."""
        n = self._next
        top = min(self._max_level, len(d_adj) - 1)
        pos = 0
        while pos < n:
            b = _pow2_batch(min(batch_rows, n - pos))
            slots = np.arange(pos, pos + b, dtype=np.int32)
            bq = self._upload(self._vecs[pos:pos + b])
            cur = self._descend(d_vecs, d_sqn, d_adj, bq, top, beam["compute_dtype"])
            cand_dist, cand_ids = _beam_search_l0(
                d_vecs, d_sqn, d_adj[0], d_alive, bq, cur, **beam)
            cand_dist, cand_ids = _drop_self(
                cand_dist, cand_ids,
                torch.arange(pos, pos + b, device=self.device))
            self._connect_batch(d_vecs, d_sqn, d_adj[0], 0, slots, cand_dist,
                                cand_ids, overwrite_forward=False)
            pos += b

    # -- clustered bulk construction (ingest-rate path) ----------------------
    def bulk_build_auto(self, vectors: np.ndarray, **kw) -> np.ndarray:
        """Builder policy for engine ingest, the reference's: the clustered
        build, then one ef=32 beam-refinement round over the finished graph
        (the clustered blocks supply dense local candidates cheaply; the
        beam round restores the cross-cluster edges the partition misses).
        Sequential-parity construction remains ``insert`` / ``bulk_build``.
        Recorded as the span ``hnsw.build``."""
        with trace.span("hnsw.build"):
            out = self.bulk_build_clustered(vectors, **kw)
            self.beam_refine(rounds=1, ef=32, batch_rows=4096)
        return out

    @_locked
    def bulk_build_clustered(
        self,
        vectors: np.ndarray,
        *,
        cluster_size: int = 2048,
        spill: int = 2,
        kmeans_iters: int = 8,
        kmeans_sample: int = 131_072,
        build_dtype=torch.bfloat16,
        levels: Optional[np.ndarray] = None,
        seed: Optional[int] = None,
        descent_rounds: int = 0,
    ) -> np.ndarray:
        """Batch construction from products: k-means partition + per-cluster
        dense kNN blocks + heuristic selection + one global reverse pass.

        Rows are k-means-partitioned (sampled Lloyd), and each cluster
        scores its member rows against the cluster's rows *plus spill-ins*
        (rows whose 2nd-nearest cluster is this one) in one [rows, cols]
        product. Per-row candidate lists run the full efConstruction deep,
        and forward edges use the heuristic's diversity pruning when the
        config asks for it. Spill-in columns stitch neighboring clusters
        together; upper levels are built the same way over their subsets.
        ``descent_rounds`` NN-descent rounds re-select level 0's edges
        from neighbors-of-neighbors and random rows. Returns slots 0..N-1
        in input order.
        """
        if self._count != 0 or self._next != 0:
            raise RuntimeError("bulk_build_clustered requires an empty index")
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        n, d = vecs.shape
        if d != self.dim:
            raise ValueError(f"dim {d} != index dim {self.dim}")
        if n == 0:
            return np.zeros(0, np.int32)
        cfg = self.config
        rng = self._rng if seed is None else np.random.default_rng(seed)
        if levels is None:
            u = rng.random(n)
            levels = np.floor(
                -np.log(np.maximum(u, 1e-12)) * cfg.level_multiplier
            ).astype(np.int32)
        else:
            levels = np.asarray(levels, np.int32)

        self._ensure_capacity(n)
        max_level = int(levels.max(initial=0))
        self._ensure_level(max_level)
        self._vecs[:n] = vecs
        self._sqn[:n] = np.einsum("nd,nd->n", vecs, vecs, dtype=np.float32)
        self._levels[:n] = levels
        self._next = n

        d_vecs = self._upload(self._vecs, build_dtype)
        d_sqn = self._upload(self._sqn)

        for lvl in range(max_level + 1):
            ids_l = np.arange(n, dtype=np.int32) if lvl == 0 else (
                np.where(levels >= lvl)[0].astype(np.int32)
            )
            if ids_l.size == 0:
                continue
            width = cfg.m_max0 if lvl == 0 else cfg.m_max
            adj = self._upload(self._adj[lvl])
            self._build_level_clustered(
                d_vecs, d_sqn, ids_l, adj,
                width=width, cluster_size=cluster_size, spill=spill,
                kmeans_iters=kmeans_iters, kmeans_sample=kmeans_sample,
                rng=rng, compute_dtype=build_dtype,
            )
            self._adj[lvl] = adj.cpu().numpy().copy()

        for _ in range(max(0, descent_rounds)):
            adj0 = self._upload(self._adj[0])
            self._nn_descent_level(d_vecs, d_sqn, adj0, n, width=cfg.m_max0,
                                   compute_dtype=build_dtype)
            self._adj[0] = adj0.cpu().numpy().copy()

        self._alive[:n] = True
        self._count = n
        self._max_level = max_level
        self._entry = int(np.argmax(levels))
        self._invalidate_cache()
        return np.arange(n, dtype=np.int32)

    def _build_level_clustered(self, d_vecs, d_sqn, ids_l, adj, *, width,
                               cluster_size, spill, kmeans_iters,
                               kmeans_sample, rng, compute_dtype) -> None:
        """One level of the clustered build; updates that level's device
        adjacency ``adj`` in place."""
        cfg = self.config
        m = min(cfg.m, width)
        nl = ids_l.size
        cosine = self.metric == Metric.COSINE
        dev = self.device

        if nl <= max(2 * cluster_size, 256):
            members = [ids_l]           # single dense block, no partition
            spills = [np.zeros(0, np.int32)]
        else:
            c = _pow2_ceil(max(2, spill * nl // cluster_size))
            samp = ids_l if nl <= kmeans_sample else np.asarray(
                rng.choice(ids_l, size=kmeans_sample, replace=False)
            )
            xs = d_vecs[torch.as_tensor(samp, dtype=torch.long, device=dev)
                        ].to(torch.float32)
            if cosine:
                xs = xs / torch.clamp(torch.linalg.norm(xs, dim=1, keepdim=True),
                                      min=1e-30)
            init = rng.choice(samp.size, size=c, replace=samp.size < c)
            cents = xs[torch.as_tensor(init, dtype=torch.long, device=dev)]
            for _ in range(kmeans_iters):
                cents = _lloyd_step(xs, cents, cosine=cosine)
            del xs
            # top-`spill` cluster assignment for every row, chunked
            parts = []
            chunk = 65_536
            for i in range(0, nl, chunk):
                sub = torch.as_tensor(ids_l[i:i + chunk], dtype=torch.long, device=dev)
                parts.append(_assign_spill(d_vecs[sub], cents, spill=spill,
                                           cosine=cosine))
            assign = torch.cat(parts).cpu().numpy()
            members, spills = [], []
            for ci in range(c):
                members.append(ids_l[assign[:, 0] == ci])
                spills.append(
                    ids_l[(assign[:, 1:] == ci).any(axis=1)]
                    if spill > 1 else np.zeros(0, np.int32)
                )

        # phase 1: per-cluster candidates + forward selection
        subs, fwds = [], []
        for rows, sp in zip(members, spills):
            if rows.size == 0:
                continue
            cols = np.concatenate([rows, sp])
            # the reference's padded column count (at least 256, a power of
            # two): it sets the candidate list's depth where the cluster is
            # narrower than efConstruction
            cpad = _pow2_ceil(max(cols.size, 256))
            col_valid = torch.zeros(cpad, dtype=torch.bool, device=dev)
            col_valid[: cols.size] = True
            j_cols = torch.as_tensor(
                np.concatenate([cols, np.repeat(cols[:1], cpad - cols.size)]),
                dtype=torch.long, device=dev)
            qchunk = 1024
            for i in range(0, rows.size, qchunk):
                sub = rows[i:i + qchunk]
                j_sub = torch.as_tensor(sub, dtype=torch.long, device=dev)
                fwd = _cluster_connect(
                    d_vecs, d_sqn, j_sub, j_cols, col_valid,
                    efc=cfg.ef_construction, m=m, metric=self.metric,
                    heuristic=cfg.algorithm == HEURISTIC,
                    keep_pruned=cfg.heuristic_keep_pruned,
                    compute_dtype=compute_dtype,
                )
                fwd_rows = torch.full((sub.size, width), -1, dtype=adj.dtype,
                                      device=dev)
                fwd_rows[:, :m] = fwd.to(adj.dtype)
                adj[j_sub] = fwd_rows
                subs.append(sub)
                fwds.append(fwd)

        # phase 2: fetch forward lists (one copy), one global reverse pass
        if subs:
            f = torch.cat(fwds).cpu().numpy()
            self._reverse_connect(
                d_vecs, d_sqn, adj, f.ravel(),
                np.repeat(np.concatenate(subs), f.shape[1]),
                compute_dtype=compute_dtype,
            )

    @_locked
    def beam_refine(self, *, rounds: int = 1, batch_rows: int = 2048,
                    expand: int = 16, ef: Optional[int] = None,
                    build_dtype=torch.bfloat16) -> None:
        """Beam-refinement rounds over the FINISHED graph: every point
        re-searches level 0 with the batched device beam and merges the
        fresh candidates into both edge directions (``bulk_build``'s
        refinement loop as a standalone pass). ``ef`` defaults to
        ef_construction; smaller values trade recall recovery for
        refinement cost. Works on any built index."""
        if self._count == 0:
            return
        cfg = self.config
        efc = cfg.ef_construction if ef is None else max(int(ef), cfg.m)
        max_iters = max(2 * efc // max(expand, 1), 16)
        d_vecs = self._upload(self._vecs, build_dtype)
        d_sqn = self._upload(self._sqn)
        d_alive = self._upload(self._alive)
        d_adj = [self._upload(a) for a in self._adj]
        beam = dict(ef=efc, k=efc, expand=expand, max_iters=max_iters,
                    metric=self.metric, compute_dtype=build_dtype)
        for _ in range(max(0, rounds)):
            self._refine_round(d_vecs, d_sqn, d_alive, d_adj, batch_rows, beam)
        self._adj[0] = d_adj[0].cpu().numpy().copy()
        self._invalidate_cache()

    def _nn_descent_level(self, d_vecs, d_sqn, adj, n: int, *, width: int,
                          compute_dtype, rand_cands: int = 32) -> None:
        """One NN-descent round over rows 0..n-1 of one level, in place:
        phase 1 computes every row's new forward selection against the OLD
        graph (row batches sized from free device memory), phase 2 applies
        the forward overwrites and one global reverse pass."""
        cfg = self.config
        m = min(cfg.m, width)
        c = width + width * width + rand_cands
        # the [B, C, D] candidate gather and its f32 copy, the [B, C] keys
        per_row = c * (d_vecs.shape[1] * (d_vecs.element_size() + 4) + 32)
        batch_rows = fit_rows(n, per_row, self.device)
        subs, fwds = [], []
        for pos in range(0, n, batch_rows):
            sub = np.arange(pos, min(pos + batch_rows, n), dtype=np.int32)
            rand = self._rng.integers(0, n, (sub.size, max(rand_cands, 1)),
                                      dtype=np.int32)
            fwds.append(_nn_descent_block(
                d_vecs, d_sqn, adj,
                torch.as_tensor(sub, dtype=torch.long, device=self.device),
                torch.as_tensor(rand, device=self.device),
                efc=cfg.ef_construction, m=m, metric=self.metric,
                heuristic=cfg.algorithm == HEURISTIC,
                keep_pruned=cfg.heuristic_keep_pruned,
                compute_dtype=compute_dtype,
            ))
            subs.append(sub)
        for sub, fwd in zip(subs, fwds):
            rows_full = torch.full((sub.size, width), -1, dtype=adj.dtype,
                                   device=self.device)
            rows_full[:, :m] = fwd.to(adj.dtype)
            adj[torch.as_tensor(sub, dtype=torch.long, device=self.device)] = rows_full
        f = torch.cat(fwds).cpu().numpy()
        self._reverse_connect(d_vecs, d_sqn, adj, f.ravel(),
                              np.repeat(np.concatenate(subs), f.shape[1]),
                              compute_dtype=compute_dtype)

    def remove(self, slot: int) -> bool:
        """Remove (hnsw.go:191-242): tombstone + relink neighbors so the
        graph stays connected through the hole."""
        with self._mu:
            return self._remove_locked(slot)

    def _remove_locked(self, slot: int) -> bool:
        if slot < 0 or slot >= self._levels.shape[0] or not self._alive[slot]:
            return False
        self._alive[slot] = False
        self._count -= 1
        self._dirty.add(int(slot))
        for l in range(int(self._levels[slot]) + 1):
            nbrs = self._adj[l][slot]
            nbrs = [int(x) for x in nbrs[nbrs >= 0] if self._alive[int(x)]]
            # connect surviving neighbors pairwise (bounded)
            for i, a in enumerate(nbrs):
                for b in nbrs[i + 1:]:
                    self._add_edge(a, b, l)
                    self._add_edge(b, a, l)
        if slot == self._entry:
            # move entrypoint to any alive vertex at the highest level
            self._entry = -1
            for l in range(self._max_level, -1, -1):
                alive_at = np.where(self._alive & (self._levels >= l))[0]
                if alive_at.size:
                    self._entry = int(alive_at[0])
                    self._max_level = l
                    break
            if self._entry < 0:
                self._max_level = 0
        return True

    # -- search --------------------------------------------------------------
    def _device_graph(self):
        """Device-side graph snapshot ``(vectors, sqnorms, adj0, alive,
        upper levels)``, *capacity*-shaped and incrementally updated.
        Mutations record their touched rows in ``_dirty`` and the next
        search writes only those rows into the cached tensors: in place
        when no search holds the snapshot, otherwise into copies (the
        running searches keep the tensors they took). Full rebuilds happen
        only on capacity growth, level-count change, or bulk builds.
        Callers hold ``_mu``; unallocated rows are alive=False with -1
        adjacency, unreachable by construction."""
        c = self._device_cache
        cap = self._vecs.shape[0]
        if c is not None and (c[0].shape[0] != cap
                              or len(c[4]) != len(self._adj) - 1):
            c = None
        if c is None:
            self._device_cache = (
                self._upload(self._vecs, self.device_dtype),
                self._upload(self._sqn),
                self._upload(self._adj[0]),
                self._upload(self._alive),
                tuple(self._upload(a) for a in self._adj[1:]),
            )
            self._dirty.clear()
        elif self._dirty:
            rows = np.fromiter(self._dirty, np.int64, len(self._dirty))
            self._dirty.clear()
            j = torch.from_numpy(rows).to(self.device)
            with self._readers_mu:
                readers = self._readers
            vecs, sqn, adj0, alive, upper = self._device_cache
            dst = (vecs, sqn, adj0, alive) + upper
            src = (self._vecs[rows], self._sqn[rows], self._adj[0][rows],
                   self._alive[rows]) + tuple(a[rows] for a in self._adj[1:])
            out = []
            for t, s in zip(dst, src):
                s = torch.from_numpy(s).to(self.device, t.dtype)
                out.append(t.index_copy_(0, j, s) if readers == 0
                           else t.index_copy(0, j, s))
            self._device_cache = (*out[:4], tuple(out[4:]))
        return self._device_cache

    def search(
        self,
        queries: np.ndarray,
        k: int,
        *,
        ef: Optional[int] = None,
        expand: int = 16,
        device: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched top-k search. Returns (dists [Q,k], slots [Q,k]); missing
        results carry slot -1 / dist inf. ``device=False`` walks the host
        arrays (upper-level descent + level-0 beam, one query at a time).

        The device search records the spans ``hnsw.descend`` (the upper
        levels' greedy walk), ``hnsw.beam`` (level 0) and ``hnsw.fetch``
        (the results to the host), under the calling thread's RPC method,
        and adds its work to the counters ``hnsw.queries`` and ``hnsw.<w>``
        for each ``w`` of ``_WORK``: the algorithm's work, whatever the
        launches that do it."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        qn, _ = queries.shape
        ef = max(self.config.ef if ef is None else ef, k)
        with self._mu:
            if self._entry < 0 or self._count == 0:
                return (np.full((qn, k), np.inf, np.float32),
                        np.full((qn, k), -1, np.int32))

            if not device:
                # walks the mutable host arrays, so it holds the lock
                dists = np.full((qn, k), np.inf, np.float32)
                slots = np.full((qn, k), -1, np.int32)
                for i in range(qn):
                    cur = self._entry
                    for l in range(self._max_level, 0, -1):
                        cur = self._greedy_level(queries[i], cur, l)
                    res = [
                        (d, nid)
                        for d, nid in self._search_level(queries[i], cur, ef, 0)
                        if self._alive[nid]
                    ][:k]
                    for j, (d, nid) in enumerate(res):
                        dists[i, j] = d
                        slots[i, j] = nid
                return dists, slots

            # snapshot under the lock; while it is live, mutations write the
            # device cache out of place, so the beam below runs lock-free
            # against a consistent graph
            vectors, sqn, adj0, alive, upper = self._device_graph()
            entry = self._entry
            max_level = self._max_level
            with self._readers_mu:
                self._readers += 1
        method = trace.method()
        try:
            # gRPC hands a read-only buffer; torch wants writable memory
            tq = torch.from_numpy(np.require(queries, requirements="W")).to(self.device)
            entries = torch.full((qn,), entry, dtype=torch.long, device=self.device)
            work = torch.zeros(len(_WORK), dtype=torch.long, device=self.device)
            # upper-level greedy descent, batched on device per level
            with trace.span("hnsw.descend", method):
                for l in range(min(max_level, len(upper)), 0, -1):
                    entries = _greedy_descent(
                        vectors, sqn, upper[l - 1], tq, entries,
                        metric=self.metric, compute_dtype=self.device_dtype,
                        work=work,
                    )
            with trace.span("hnsw.beam", method):
                d, ids = _beam_search_l0(
                    vectors, sqn, adj0, alive, tq, entries,
                    ef=ef, k=k, expand=expand,
                    max_iters=max(2 * ef // max(expand, 1), 8),
                    metric=self.metric, compute_dtype=self.device_dtype,
                    work=work,
                )
            with trace.span("hnsw.fetch", method):
                d, ids = fetch_scores_ids(d, ids)
            work = work.tolist()
        finally:
            with self._readers_mu:
                self._readers -= 1
        trace.count("hnsw.queries", qn)
        for name, n in zip(_WORK, work):
            trace.count(f"hnsw.{name}", n)
        if d.shape[1] < k:
            pad = k - d.shape[1]
            d = np.concatenate([d, np.full((qn, pad), np.inf, np.float32)], axis=1)
            ids = np.concatenate([ids, np.full((qn, pad), -1, np.int32)], axis=1)
        return d, ids

    # -- snapshot (hnsw_commit.go Commit/Load parity) -------------------------
    @_locked
    def save(self, f: io.BufferedIOBase) -> None:
        n = self._next
        header = {
            "dim": self.dim,
            "metric": int(self.metric),
            "config": self.config.to_dict(),
            "entry": self._entry,
            "max_level": self._max_level,
            "count": self._count,
            "next": n,
            # raw LE arrays, not per-element lists in the msgpack header
            "levels_bin": self._levels[:n].astype("<i4").tobytes(),
            "alive_bin": np.packbits(self._alive[:n]).tobytes(),
        }
        hb = msgpack.packb(header, use_bin_type=True)
        f.write(_SNAPSHOT_MAGIC)
        f.write(len(hb).to_bytes(8, "big"))
        f.write(hb)
        f.write(self._vecs[:n].tobytes())
        f.write(struct.pack(">I", len(self._adj)))
        for adj in self._adj:
            f.write(struct.pack(">II", adj.shape[1], n))
            f.write(adj[:n].astype(">i4").tobytes())

    @classmethod
    def load(cls, f: io.BufferedIOBase, *, device="cuda",
             device_dtype=torch.float32) -> "HnswIndex":
        """Read a snapshot written by either package (the pre-r04 list form
        of levels / alive included) into an index on ``device``."""
        magic = f.read(len(_SNAPSHOT_MAGIC))
        if magic != _SNAPSHOT_MAGIC:
            raise ValueError("not an HNSW snapshot")
        hlen = int.from_bytes(f.read(8), "big")
        h = msgpack.unpackb(f.read(hlen), raw=False)
        idx = cls(
            h["dim"],
            metric=Metric.parse(h["metric"]),
            config=HnswConfig.from_dict(h["config"]),
            base_capacity=max(h["next"], 1024),
            device_dtype=device_dtype,
            device=device,
        )
        n = h["next"]
        vecs = np.frombuffer(f.read(n * h["dim"] * 4), np.float32).reshape(n, h["dim"])
        idx._vecs[:n] = vecs
        idx._sqn[:n] = (vecs * vecs).sum(1)
        if "levels_bin" in h:
            idx._levels[:n] = np.frombuffer(h["levels_bin"], "<i4")
            idx._alive[:n] = np.unpackbits(
                np.frombuffer(h["alive_bin"], np.uint8), count=n
            ).astype(bool)
        else:  # pre-r04 snapshots carried per-element lists
            idx._levels[:n] = np.asarray(h["levels"], np.int32)
            idx._alive[:n] = np.asarray(h["alive"], bool)
        (nlevels,) = struct.unpack(">I", f.read(4))
        idx._adj = []
        for _ in range(nlevels):
            width, rows = struct.unpack(">II", f.read(8))
            adj = np.frombuffer(f.read(rows * width * 4), ">i4").astype(np.int32)
            full = np.full((idx._vecs.shape[0], width), -1, np.int32)
            full[:rows] = adj.reshape(rows, width)
            idx._adj.append(full)
        idx._entry = h["entry"]
        idx._max_level = h["max_level"]
        idx._count = h["count"]
        idx._next = n
        return idx
