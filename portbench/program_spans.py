"""Reductions over the program's own spans, for the per-layer readers.

The program (``coltt_tpu_torch/utils/trace.py``) records its spans in a
ring inside the process that serves them, which is the run's own process
(``modes/<mode>.py`` builds the server there). A span is ``(name, method,
thread, start, end)``, stamped on ``time.monotonic``: the clock of the
clients' ``sent`` / ``done`` and of the aligned device trace. The spans
read here:

- ``rpc.queue`` (grpc's pool, submit to start) and ``rpc.call`` (the pool
  task: the wait for the message, the handler, serialization, the start
  of the send), with ``rpc.decode``, ``rpc.handler``, ``rpc.reply`` and
  ``rpc.encode``, each under its RPC's method;
- ``engine.index_many``, ``store.sync`` (rows applied), ``store.fetch``
  (the host waiting on the device's top-k) and ``batcher.wait``.

Every reduction returns None where the program records no spans (an
older program without ``utils/trace.py``), where the ring no longer
reaches back to the part a reader reads, or where it finds no span. The
run's process serves one cell, so every span before the window belongs
to the cell's set-up.
"""

from __future__ import annotations

import numpy as np

from portbench.trace import busy_intervals


def _ring():
    try:
        from coltt_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def held(lo: float, hi: float):
    """The program's spans overlapping ``[lo, hi]``, or None where it has no
    ring or the ring no longer holds every span from ``lo`` on."""
    trace = _ring()
    if trace is None:
        return None
    oldest = trace.oldest()
    if oldest is None or oldest > lo:
        return None
    return trace.spans(lo, hi)


def in_window(rec: dict, name: str, method=None):
    """``(thread, start, end)`` of the spans ``name`` (of ``method``, where
    given) that start inside the window, or None."""
    t0, t1 = rec["window"]
    spans = held(t0, t1)
    if spans is None:
        return None
    return [(th, s, e) for n, m, th, s, e in spans
            if n == name and (method is None or m == method) and t0 <= s <= t1]


def mean_ms(rec: dict, name: str, method=None):
    """The mean duration of the spans ``name`` in the window, in ms."""
    got = in_window(rec, name, method)
    if not got:
        return None
    return 1e3 * float(np.mean([e - s for _, s, e in got]))


def per_request_ms(rec: dict, name: str, method: str):
    """The summed duration of the spans ``name`` in the window over the
    number of ``method`` calls handled there (``rpc.handler``), in ms."""
    spans, calls = in_window(rec, name), in_window(rec, "rpc.handler", method)
    if not spans or not calls:
        return None
    return 1e3 * sum(e - s for _, s, e in spans) / len(calls)


def _requests(rec: dict):
    """``(sent, done, ok)`` of every request of the window."""
    r = rec["requests"]
    return (np.asarray(r["sent"], float), np.asarray(r["done"], float),
            np.asarray(r["ok"], bool))


def outside_server_ms(rec: dict, rpc: str):
    """The mean over the answered requests of ``rpc`` of the client's
    latency minus the server's time for it (its task's ``rpc.queue`` +
    ``rpc.call``), in ms. A server call belongs to the client request whose
    ``[sent, done]`` holds its submit, where just one does and that request
    holds no other call: with one closed-loop client, always."""
    if rec["rpc"] != rpc:
        return None
    calls = in_window(rec, "rpc.call", rpc)
    queues = in_window(rec, "rpc.queue", rpc)
    if not calls or queues is None:
        return None
    submit = {(th, e): s for th, s, e in queues}   # a task's queue ends as its call starts
    sent, done, ok = _requests(rec)
    owner: dict = {}
    for th, s, e in calls:
        t = submit.get((th, s))
        if t is None:
            continue
        holders = np.nonzero((sent <= t) & (t <= done))[0]
        if holders.size == 1:
            owner.setdefault(int(holders[0]), []).append(e - t)
    diffs = [done[i] - sent[i] - ts[0] for i, ts in owner.items()
             if len(ts) == 1 and ok[i]]
    return 1e3 * float(np.mean(diffs)) if diffs else None


def batcher_wait_ms(rec: dict, rpc: str):
    """The summed ``batcher.wait`` inside the answered requests of ``rpc``
    over their number, in ms."""
    if rec["rpc"] != rpc:
        return None
    waits = in_window(rec, "batcher.wait")
    if not waits:
        return None
    sent, done, ok = _requests(rec)
    sent, done = sent[ok], done[ok]
    if not sent.size:
        return None
    inside = sum(e - s for _, s, e in waits if ((sent <= s) & (s <= done)).any())
    return 1e3 * inside / sent.size


def ingest_s(rec: dict):
    """``engine.index_many`` plus the ``store.sync`` spans that applied
    rows, all ended before the window opens, in s."""
    trace = _ring()
    if trace is None:
        return None
    t0 = rec["window"][0]
    spans = [sp for sp in trace.spans(hi=t0) if sp[4] <= t0]
    ingest = [sp for sp in spans if sp[0] == "engine.index_many"]
    if not ingest or trace.oldest() > min(sp[3] for sp in ingest):
        return None
    return sum(e - s for n, _, _, s, e in spans
               if n in ("engine.index_many", "store.sync"))


def _length(intervals: list) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def idle_outside_server_share(rec: dict):
    """The share of the traced sub-window's device-idle time that no
    ``rpc.call`` or ``rpc.decode`` span of any thread covers, in %: the
    window less the union of the device's busy intervals and those spans,
    over the window less the busy intervals."""
    p = rec.get("profile")
    if not p or not p["device"]:
        return None
    lo, hi = p["start"], p["end"]
    spans = held(lo, hi)
    if spans is None:
        return None
    server = [(max(s, lo), min(e, hi)) for n, _, _, s, e in spans
              if n in ("rpc.call", "rpc.decode") and e > lo and s < hi]
    if not server:
        return None
    busy = busy_intervals(p["device"], lo, hi)
    idle = (hi - lo) - _length(busy)
    if idle <= 0:
        return None
    return 100.0 * ((hi - lo) - _length(busy + server)) / idle
