"""Reductions for the per-layer readers of core mode's served path
(``modes/root.py``): the program's spans of the HNSW search and of its
ingest, its work counters, and the bytes that work moves.

The program (``coltt_tpu_torch``) records in its ring (``utils/trace.py``):

- in every device search (``store/hnsw.py`` ``HnswIndex.search``), under
  the request's method: ``hnsw.descend`` (the upper levels' greedy walk),
  ``hnsw.beam`` (level 0) and ``hnsw.fetch`` (the results to the host);
  ``engine.flatten`` (``engine/core.py`` ``vector_search_batch``, the hits
  to the reply's columns) and ``rpc.reply`` (``CoreServicer``'s
  response);
- at ingest: ``engine.bulk_insert``, holding ``hnsw.build``
  (``bulk_build_auto``) and the commit log's ``kv.commit`` batches, and
  ``kv.sync``;
- the counters ``hnsw.queries`` and ``hnsw.descend_hops``,
  ``hnsw.beam_iters``, ``hnsw.scored`` (neighbour distances),
  ``hnsw.expanded`` (adjacency rows read) and ``hnsw.blocks`` (query
  blocks): the algorithm's work, totals over every search of the
  process, the clients' warm-up included.

Every reduction returns None on a program without them.
"""

from __future__ import annotations

from portbench.program_spans import _ring, held
from portbench.roofline import HBM_BYTES_PER_S
from portbench.trace import busy_intervals, is_kernel

F32 = 4
ID = 4   # an adjacency entry: an int32 vertex id


def search_bytes(scored: float, expanded: float, dim: int, m0: int) -> float:
    """The least bytes a graph search's work reads: each scored neighbour's
    f32 vector and norm once, and each expanded vertex's level-0 row of
    ``m0`` int32 ids (the upper levels' rows are narrower, so their reads
    count a little high)."""
    return scored * (dim * F32 + F32) + expanded * m0 * ID


def setup_s(rec: dict, names: tuple):
    """The spans ``names`` that ended before the window opens, summed, in
    s; None where the program recorded no ``names[0]`` span or the ring no
    longer holds it."""
    trace = _ring()
    if trace is None:
        return None
    t0 = rec["window"][0]
    spans = [sp for sp in trace.spans(hi=t0) if sp[4] <= t0]
    first = [sp for sp in spans if sp[0] == names[0]]
    if not first or trace.oldest() > min(sp[3] for sp in first):
        return None
    return sum(e - s for n, _, _, s, e in spans if n in names)


def counter_ratio(num: str, den: str):
    """The program's counter ``num`` over its counter ``den``, or None."""
    trace = _ring()
    if trace is None:
        return None
    c = trace.counters()
    return c[num] / c[den] if c.get(den) and num in c else None


def searches(spans: list, lo: float, hi: float) -> list:
    """``(start, end)`` of each search lying inside ``[lo, hi]``: from its
    ``hnsw.descend`` to the end of the thread's next ``hnsw.fetch``, which
    waits for the kernels the beam launched."""
    out = []
    for n, _, th, s, _ in spans:
        if n != "hnsw.descend" or s < lo:
            continue
        end = next((e for n2, _, th2, s2, e in spans
                    if n2 == "hnsw.fetch" and th2 == th and s2 >= s), None)
        if end is not None and end <= hi:
            out.append((s, end))
    return out


def roofline(rec: dict):
    """The searches' share of their bandwidth roofline in the traced
    sub-window, in %: the bytes of their work (:func:`search_bytes` from
    the counters, per query, times the queries of the searches that lie
    inside the sub-window) at the HBM rate, over the device time of the
    kernels inside those searches."""
    p = rec.get("profile")
    graph = rec["logs"].get("hnsw_graph")
    if not p or not p["device"] or not graph:
        return None
    trace = _ring()
    if trace is None:
        return None
    c = trace.counters()
    if not c.get("hnsw.queries"):
        return None
    lo, hi = p["start"], p["end"]
    spans = held(lo, hi)
    if spans is None:
        return None
    inside = searches(spans, lo, hi)
    kernels = [ev for ev in p["device"] if is_kernel(ev[0])]
    busy = sum(e - s for a, b in inside for s, e in busy_intervals(kernels, a, b))
    nq = rec["requests"]["nq"]
    if not inside or busy <= 0 or not len(nq):
        return None
    g = graph[0]
    per_query = search_bytes(c["hnsw.scored"], c["hnsw.expanded"], g["dim"],
                             g["m0"]) / c["hnsw.queries"]
    moved = per_query * float(nq.mean()) * len(inside)
    return 100.0 * moved / HBM_BYTES_PER_S / busy
