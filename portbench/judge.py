"""The check that decides ``correct``: the served answers against the
plain reference (``reference.py``).

The answers are a seeded uniform sample of every answer the clients got in
the window (``client.Reservoir``): for each, its pool query, its hit count
and its hits' row ids and scores as they came over the wire. The numbers:

- ``missing_hits``: hits short of k, over all sampled answers, counting a
  primary key that names no row and a row given twice as missing (exact:
  every answer has k distinct rows);
- ``score_gap``: the widest gap between a served score and the float64
  score of the same (query, row) pair, on the 0-100 scale;
- ``rank_gap``: the widest gap by which a served row's float64 score lies
  below the score of the query's exact k-th best row (0 where every served
  row is at least as good as the k-th best);
- ``miss_share``: the share of each sampled answer's exact top k (under
  the mix's filter) that it does not hold, counting its valid, distinct
  rows only, over all sampled answers: a search that never reaches part
  of the collection serves exact scores of good rows, and only this
  number sees the rows it left out;
- ``recall_at_10``: ``1 - miss_share`` on the same sample (an end-to-end
  metric, not compared).

A cell's limits file names the numbers it compares and their limits;
``correct`` needs each at or under its limit, and every request answered.
"""

from __future__ import annotations

import numpy as np

from portbench import reference

OPS = {"EQ": np.equal, "NEQ": np.not_equal, "GT": np.greater,
       "GTE": np.greater_equal, "LT": np.less, "LTE": np.less_equal}


def allowed_rows(n: int, flt: dict | None):
    """The rows a mix's filter keeps (its field holds the row number), or
    None for every row."""
    if not flt:
        return None
    return np.nonzero(OPS[flt["op"]](np.arange(n), int(flt["int"])))[0]


def numbers(sample: dict, pool: np.ndarray, rows: np.ndarray, k: int,
            metric: str, device, flt: dict | None = None) -> dict:
    """The check's numbers for ``sample`` (``pool`` / ``count`` / ``ids`` /
    ``scores`` arrays, ``ids`` and ``scores`` ``[S, k]``)."""
    pidx = np.asarray(sample["pool"], np.int64)
    s = len(pidx)
    if s == 0:
        return {"answers": 0}
    ids = np.asarray(sample["ids"], np.int64)[:, :k]
    served = np.asarray(sample["scores"], np.float64)[:, :k]
    uq, inv = np.unique(pidx, return_inverse=True)
    queries = np.ascontiguousarray(pool[uq])
    keep = allowed_rows(rows.shape[0], flt)
    scan_rows = rows if keep is None else rows[keep]
    _, ref_ids = reference.exact_topk(queries, scan_rows, k, metric, device)
    if keep is not None:
        ref_ids = keep[ref_ids]

    col = np.arange(k)[None, :]
    valid = (ids >= 0) & (ids < rows.shape[0]) & (col < sample["count"][:, None])
    if keep is not None:
        valid &= np.isin(ids, keep)
    # a row given twice in one answer counts once
    srt = np.sort(np.where(valid, ids, -1), axis=1)
    dup = np.zeros_like(valid)
    dup[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    missing = int(k * s - valid.sum() + dup.sum())

    qi, ci = np.nonzero(valid)
    exact = reference.pair_scores(queries, rows, inv[qi], ids[qi, ci], metric,
                                  device)
    kth = reference.pair_scores(queries, rows, np.arange(len(uq)),
                                ref_ids[:, k - 1], metric, device)
    gap = np.abs(served[qi, ci] - exact)
    below = kth[inv[qi]] - exact
    hits = sum(len(np.intersect1d(ids[r][valid[r]], ref_ids[inv[r]]))
               for r in range(s))
    return {
        "answers": s,
        "missing_hits": missing,
        "score_gap": float(gap.max()) if gap.size else 0.0,
        "rank_gap": float(max(0.0, below.max())) if below.size else 0.0,
        "miss_share": (k * s - hits) / (k * s),
        "recall_at_10": hits / (k * s),
    }


def verdict(found: dict, limits: dict, attempted: int,
            failed: int) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit"}})``: each compared number
    with its limit, the requests that got no answer first."""
    checked = {"failed_requests": {"value": failed, "limit": 0}}
    ok = failed == 0 and attempted > 0 and found.get("answers", 0) > 0
    for name, lim in limits["compare"].items():
        value = found.get(name)
        checked[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and value is not None and value <= lim["limit"]
    return ok, checked
